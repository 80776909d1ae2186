"""Checkpoint files of the port.

The trainer writes `torch.save({"step", "model", "optimizer"})` to
`<train_dir>/ckpt/<step>.pt`: the step count, the model's state_dict
(parameters and BatchNorm running statistics) and the Adam state. The JAX
package's orbax directories `ckpt/<step>/default` are not read here; flax
variables come over through models/convert.py. Loading accepts a trainer
checkpoint or a bare model state_dict (eval/evaler.py:save_checkpoint).
"""

import os

import torch

CKPT_DIR = "ckpt"


def checkpoint_path(train_dir, step):
    return os.path.join(train_dir, CKPT_DIR, f"{step}.pt")


def checkpoint_steps(train_dir):
    """Steps of the checkpoints in `train_dir`, ascending."""
    ckpt_dir = os.path.join(train_dir, CKPT_DIR)
    if not os.path.isdir(ckpt_dir):
        return []
    names = (os.path.splitext(n) for n in os.listdir(ckpt_dir))
    return sorted(int(stem) for stem, ext in names
                  if ext == ".pt" and stem.isdigit())


def latest_checkpoint(train_dir):
    """Path of the newest checkpoint in `train_dir`, or None."""
    steps = checkpoint_steps(train_dir)
    return checkpoint_path(train_dir, steps[-1]) if steps else None


def save(state, path):
    """Write through a temporary file, so a killed run leaves no partial
    checkpoint for auto-resume to pick up."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def is_train_state(ckpt):
    return isinstance(ckpt.get("model"), dict) and "optimizer" in ckpt


def model_state_dict(ckpt):
    """The model's state_dict in a trainer checkpoint or a bare one."""
    return ckpt["model"] if is_train_state(ckpt) else ckpt
