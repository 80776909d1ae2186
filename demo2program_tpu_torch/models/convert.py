"""flax `params` + `batch_stats` (trees of numpy arrays) -> the port's
`state_dict`.

The port's module names mirror the flax tree, so the walk only renames the
auto-named flax nodes and converts leaves by the kind of node that holds
them:

  Conv_0         kernel HWIO -> conv.weight OIHW, bias -> conv.bias
  Dense layers   any node holding a 2-D kernel (and a bias): Dense_0
                 (-> dense), output_projection, memory_layer,
                 attention_layer, concat_proj_h/_c; kernel (in, out) ->
                 weight (out, in), bias
  BNAct_0/BatchNorm_0
                 scale, bias, batch_stats mean, var -> bn_act.bn.weight,
                 .bias, .running_mean, .running_var
  embedding      copied
  LSTM cells     ("cell", "PallasLSTMCell_0", "OptimizedLSTMCell_0")
                 -> cell.kernel (D+H, 4H), cell.bias (4H,). The fused
                 layout (cell_impl "pallas"/"pallas_jnp") is copied as is;
                 nn.OptimizedLSTMCell's per-gate kernels (cell_impl "xla",
                 the JAX CLI default) are folded into it: the input kernels
                 ii/if/ig/io (no bias) stack over the hidden kernels
                 hi/hf/hg/ho, and the hidden biases form the bias, in gate
                 order (i, f, g, o).
"""

import numpy as np
import torch

_RENAME = {"Conv_0": "conv", "Dense_0": "dense", "BNAct_0": "bn_act",
           "BatchNorm_0": "bn"}
_GATES = ("i", "f", "g", "o")


def _is_cell(name):
    return name == "cell" or name.endswith("LSTMCell_0")


def _is_dense(node):
    """A flax nn.Dense's params: {kernel (in, out)[, bias]}."""
    return (set(node) in ({"kernel"}, {"kernel", "bias"})
            and np.ndim(node["kernel"]) == 2)


def fold_lstm_cell(tree):
    """A flax LSTM cell's params -> (kernel (D+H, 4H), bias (4H,))."""
    if "kernel" in tree:  # the fused layout
        return np.asarray(tree["kernel"]), np.asarray(tree["bias"])
    w_x = np.concatenate([np.asarray(tree["i" + g]["kernel"])
                          for g in _GATES], axis=1)
    w_h = np.concatenate([np.asarray(tree["h" + g]["kernel"])
                          for g in _GATES], axis=1)
    b = np.concatenate([np.asarray(tree["h" + g]["bias"]) for g in _GATES])
    return np.concatenate([w_x, w_h], axis=0), b


def _walk(params, stats, prefix, out):
    for name, node in params.items():
        sub = stats.get(name, {})
        if _is_cell(name):
            kernel, bias = fold_lstm_cell(node)
            out[prefix + "cell.kernel"] = kernel
            out[prefix + "cell.bias"] = bias
        elif name == "embedding":
            out[prefix + name] = np.asarray(node)
        elif name == "Conv_0":
            out[prefix + "conv.weight"] = np.transpose(
                np.asarray(node["kernel"]), (3, 2, 0, 1))
            out[prefix + "conv.bias"] = np.asarray(node["bias"])
        elif _is_dense(node):
            p = prefix + _RENAME.get(name, name) + "."
            out[p + "weight"] = np.asarray(node["kernel"]).T
            if "bias" in node:
                out[p + "bias"] = np.asarray(node["bias"])
        elif name == "BatchNorm_0":
            p = prefix + "bn."
            out[p + "weight"] = np.asarray(node["scale"])
            out[p + "bias"] = np.asarray(node["bias"])
            out[p + "running_mean"] = np.asarray(sub["mean"])
            out[p + "running_var"] = np.asarray(sub["var"])
            out[p + "num_batches_tracked"] = np.zeros((), np.int64)
        else:
            _walk(node, sub, prefix + _RENAME.get(name, name) + ".", out)


def flax_to_state_dict(params, batch_stats=None):
    """Convert the flax variable tree of any model family to a state_dict
    of CPU tensors for the port's model of the same family."""
    out = {}
    _walk(params, batch_stats or {}, "", out)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
