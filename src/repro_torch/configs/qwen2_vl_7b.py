"""qwen2-vl-7b [arXiv:2409.12191; hf] -- VLM backbone: M-RoPE, QKV
bias; dynamic-resolution vision frontend is a STUB (input_specs
provides precomputed patch embeddings per the assignment)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
        head_dim=128, qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24), input_kind="embeds",
        tie_embeddings=False).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=160, vocab_size=512,
                           mrope_sections=(4, 2, 2), loss_chunk=16)
