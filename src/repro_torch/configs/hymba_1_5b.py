"""hymba-1.5b [arXiv:2411.13676; hf] -- hybrid: parallel attention +
Mamba heads per block, ssm_state=16.  The published model uses sliding
windows on most layers; we use a uniform 1024 window (DESIGN.md notes
the deviation: meta-tokens and the 3 global-attention layers are not
reproduced)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
        head_dim=64, ssm_state=16, ssm_conv=4, sliding_window=1024,
        rope_theta=1e4, tie_embeddings=True).validate()


def smoke_config() -> ModelConfig:
    return config().scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab_size=512,
                           ssm_state=4, sliding_window=16, loss_chunk=16)
