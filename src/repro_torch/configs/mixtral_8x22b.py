"""mixtral-8x22b [arXiv:2401.04088; hf] -- 8 experts top-2, sliding
window attention (the assignment lists SWA; window 4096)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=32768,
        head_dim=128, n_experts=8, experts_per_token=2,
        sliding_window=4096, rope_theta=1e6,
        tie_embeddings=False).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=64, vocab_size=512,
                           n_experts=4, experts_per_token=2,
                           sliding_window=16, loss_chunk=16)
