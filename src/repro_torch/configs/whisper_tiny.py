"""whisper-tiny [audio] — encoder-decoder; the conv/log-mel frontend is a
stub (input_specs supplies precomputed frame embeddings). 4L enc + 4L dec
d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51_865,
        pattern=("global",),
        encoder=EncoderConfig(n_layers=4, n_frames=1500),
        act="gelu",
        frontend="audio_stub",
    )
