"""Command-line entry points, flag-compatible with the reference:

    poppunk_tpu_torch         <-> poppunk          (__main__.py)
    poppunk_tpu_torch_assign  <-> poppunk_assign   (assign.py)
"""
