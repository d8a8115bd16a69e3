"""musicgen-large [arXiv:2306.05284; hf] -- decoder-only transformer
over EnCodec tokens (MHA: kv=32); the EnCodec frontend is a STUB
(input_specs provides precomputed frame embeddings)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
        head_dim=64, rope_theta=1e4, input_kind="embeds",
        tie_embeddings=True).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                           head_dim=16, d_ff=128, vocab_size=256,
                           loss_chunk=16)
