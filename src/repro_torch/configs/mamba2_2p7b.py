"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    pattern=("ssm",),
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    conv_width=4, ssm_chunk=256, tie_embeddings=True,
    source="arXiv:2405.21060")
