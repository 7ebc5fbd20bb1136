"""granite-20b [dense] — llama-arch MQA (kv=1), code model
[arXiv:2405.04324; hf].

Deviation noted in DESIGN.md: the HF checkpoint uses learned absolute
positions (gpt-bigcode lineage); we use RoPE like the rest of the dense
family -- systems behaviour (shapes, traffic, collectives) is identical.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    pattern=("global",), act="gelu", tie_embeddings=True,
    mlp_gated=False,                  # gpt-bigcode 2-matrix MLP
    source="arXiv:2405.04324")
