"""The port's benchmark (``tinyimgcodec_tpu_torch`` on CUDA cards): see
``README.md``.  Nothing here imports JAX or the JAX package, and
``reference/`` imports nothing of the program."""
