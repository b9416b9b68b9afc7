"""Recommenders over a RecContext: similar_anime, similar_users, user_prefs,
user_recs, model_recs and the batch entry points, one module each.

This package module imports nothing, so recommend.tables (the device half)
imports without pandas.
"""
