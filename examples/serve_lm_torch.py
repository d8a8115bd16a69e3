"""Serving example on the PyTorch port: batched requests against
qwen3-1.7b with the predictively managed prefix cache (the paper's
tuner driving KV-cache admission / eviction), on the card.

    PYTHONPATH=src python examples/serve_lm_torch.py         # smoke size
    PYTHONPATH=src python examples/serve_lm_torch.py --full  # published

Further arguments go to ``repro_torch.launch.serve`` (``--device cpu``
runs it on the CPU).
"""
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    args = sys.argv[1:]
    size = [] if "--full" in args else ["--smoke"]
    args = [a for a in args if a != "--full"]
    served, covered = serve_main(["--arch", "qwen3-1.7b", *size,
                                  "--requests", "24", *args])
    assert served == 24
    assert covered > 0, "recurring prefixes should get cache coverage"
    print("OK")
