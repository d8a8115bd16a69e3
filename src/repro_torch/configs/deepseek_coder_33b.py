"""deepseek-coder-33b [arXiv:2401.14196; hf] -- llama-arch dense GQA."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense", n_layers=62,
        d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
        vocab_size=32256, head_dim=128, rope_theta=1e5,
        tie_embeddings=False).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=160, vocab_size=512,
                           loss_chunk=16)
