"""qwen3-1.7b [hf:Qwen/Qwen3-8B family; hf] -- dense, GQA kv=8, qk-norm."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=6144, vocab_size=151936,
        head_dim=128, qk_norm=True, rope_theta=1e6,
        tie_embeddings=True).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab_size=512,
                           loss_chunk=16)
