"""whisper-base [audio] — enc-dec; conv frontend is a STUB: input_specs()
provides precomputed frame embeddings [B, enc_seq, d] [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64,
    pattern=("global",), act="gelu", tie_embeddings=True,
    enc_layers=6, enc_seq=1500,
    source="arXiv:2212.04356")
