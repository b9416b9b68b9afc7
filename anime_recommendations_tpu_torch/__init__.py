"""anime_recommendations_tpu_torch — the PyTorch/CUDA port of anime_recommendations_tpu.

The JAX package beside it is the reference this port is held to. The port
imports torch and never jax, and nothing of the JAX package. Layers,
mirroring the JAX package:

  config, data, utils — copies of the JAX package's framework-free modules
  models    — two-tower model (nn.Module), eval-mode head, normalized tables
  train     — .npz parameter I/O shared with the JAX package
  ops       — masked top-k (two-stage, int8, exact scan), row
              normalization and fused sparse Adam; each kernel is
              hand-written for Hopper (csrc/*.cu) with a plain torch
              version beside it
  recommend — retrieval context and the five recommenders + batch entry points
  pipeline  — a serving context from the JAX pipeline's artifact store
  serve     — in-process Engine + stdlib HTTP JSON API
  cli       — serve / query a trained run
"""

__version__ = "0.1.0"
