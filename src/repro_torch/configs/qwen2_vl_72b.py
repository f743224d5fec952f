"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (vision frontend is a
stub: input_specs supplies precomputed patch embeddings). 80L d_model=8192
64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152_064,
        pattern=("global",),
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision_stub",
        tie_embeddings=False,
    )
