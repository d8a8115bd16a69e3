"""qwen2-7b [arXiv:2407.10671; hf] -- dense GQA kv=4, QKV bias."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
        head_dim=128, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=False).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=160, vocab_size=512,
                           loss_chunk=16)
