"""Device operations: sketch distances (CUDA match-count kernels + torch
epilogue), the model classifications fused into them, the refine sweep and
HDBSCAN's Boruvka sweep (torch ops); the sparse kNN of lineage fits and
the rest of HDBSCAN run on the host."""
