"""Storage layer: HDF5 sketch databases, distance pickles, model artefacts.

File formats follow the reference's on-disk contracts (SURVEY.md §2.5) so
that databases and distances can be exchanged with the reference tools.

Copied from ``poppunk_tpu/io/__init__.py``, whose counterpart it is: this
package imports nothing of the JAX package.
"""
