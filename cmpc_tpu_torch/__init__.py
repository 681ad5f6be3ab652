"""PyTorch/CUDA port of the centroidal MPC closed loop (``cmpc_tpu``).

The module layout and function names mirror ``cmpc_tpu``; the code is
batch-first: every per-scenario tensor carries a leading batch axis
``(B, ...)`` where the JAX package wrote per-sample code under ``vmap``.
Nothing here imports JAX.
"""
