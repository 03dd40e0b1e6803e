"""Device operations: sketch distances (CUDA match-count kernel + torch
epilogue) and the BGMM classification fused into them."""
