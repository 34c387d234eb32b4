"""Command-line tools of the port: encode, convert, view, benchmark.

Run as ``python -m tinyimgcodec_tpu_torch.cli.encode`` etc.  Thin layers
over the port's ``api``; each takes ``--device`` (default: the CUDA card;
``--device cpu`` runs the kernels' plain versions).  Pillow and
matplotlib are imported only when a tool needs them.
"""
