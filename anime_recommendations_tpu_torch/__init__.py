"""anime_recommendations_tpu_torch — the PyTorch/CUDA port of anime_recommendations_tpu.

The JAX package beside it is the reference this port is held to. The port
imports torch and never jax, and nothing of the JAX package. Layers,
mirroring the JAX package:

  config, data, utils — copies of the JAX package's framework-free modules;
              the native CSV reader's binding (data/fastcsv.py) and the
              profiling hooks (utils/profiling.py)
  models    — two-tower model (nn.Module), train and eval heads, loss,
              normalized tables
  train     — dense Adam, fused Adam (pipelined, with the in-kernel
              next-batch gather) and LazyAdam; the Trainer and device-
              resident epochs; the convergence harness; .npz parameter I/O
              shared with the JAX package
  ops       — masked top-k (two-stage, int8, exact scan), IVF retrieval, row
              normalization and fused sparse Adam (with the gather); each
              kernel is hand-written for Hopper (csrc/*.cu) with a plain
              torch version beside it
  recommend — retrieval context and the five recommenders + batch entry points
  pipeline  — artifact store, the eight steps with their artifacts and
              assert_flow, run() with timings.json, a serving context from
              a run's store
  serve     — in-process Engine + stdlib HTTP JSON API
  cli       — pipeline / ingest / preprocess / train, serve / query a run
"""

__version__ = "0.1.0"
