"""Wan2.1 DiT, attention and RoPE."""
