"""End-to-end example on PyTorch: train a ~small qwen3-family LM for a few
hundred steps with the port's training path (remat, AdamW, the
fault-tolerant loop, async checkpoints, deterministic data), on the card
unless ``--device cpu`` is given.  The same arguments as
``examples/train_lm.py``.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] \
        [--device cpu]
"""

import os
import sys
import tempfile

from repro_torch.launch import train

if __name__ == "__main__":
    args = sys.argv[1:]
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "200"]
    train.main(["--arch", "qwen3-8b", "--reduced", "--d-model", "128",
                "--layers", "4", "--batch", "8", "--seq", "128",
                "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                           "repro_torch_example_ckpt"),
                "--ckpt-every", "50"] + args)
