"""PyTorch / CUDA port of the fused-spectral SAR focusing system.

Mirrors the JAX package ``repro`` module for module and imports nothing
of it (nor JAX). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
