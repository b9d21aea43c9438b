"""Registration operators: plain PyTorch around hand-written CUDA kernels
(``nn`` K5, ``ransac_score`` K6, ``icp_stats`` K7)."""
