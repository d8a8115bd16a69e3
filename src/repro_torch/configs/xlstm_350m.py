"""xlstm-350m [arXiv:2405.04517; unverified] -- alternating sLSTM +
mLSTM blocks, no separate FFN (d_ff=0; up-projections live inside the
blocks)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        tie_embeddings=True).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                           vocab_size=512, loss_chunk=16)
