"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
-- 32 experts, top-8, per-expert d_ff=512."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", n_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab_size=49155, head_dim=64, n_experts=32, experts_per_token=8,
        rope_theta=1e4, tie_embeddings=True).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=32, vocab_size=512,
                           n_experts=4, experts_per_token=2, loss_chunk=16)
