"""Ops: RMSNorm, RoPE, attention and the fused decode step, each CUDA kernel
beside its plain PyTorch version."""
