"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the M3E
mapper on one card, driven through its three entry points by cells held
in data.  ``python -m m3ebench.run --help``; README.md beside this file.
"""
