"""Import the reference's TensorFlow-1 checkpoints into the port's models:
the counterpart of the JAX package's `compat/tf_import.py`.

The reference saves full-graph `tf.train.Saver` checkpoints
(`models/base.py:240-253` there). `load_tf_variables` reads them with
`tf.train.load_checkpoint` (tensorflow is an optional dependency, imported
inside the function) and the mappers below place the reference's variable
names in the JAX package's parameter tree, which the port's models share
(its weights keep the JAX layouts, `bridge.py`):

  * ShallowNet: `ShallowNet/conv{1,2,3}/weights|biases`,
    `ShallowNet/fc{1,2}/weights|biases` (tf.contrib.layers scopes). TF's
    conv kernels are [h, w, in, out] and its fc [in, out]: the layouts
    already.
  * gaze_grcn: `proj_c3d_W/b`, the six cell kernels
    `GRU_Conv_{Wz,Uz,Wr,Ur,W,U}`, `RGP/Upsampling/weight{1,2,3}` deconv
    kernels, `out_W/b`, and the decoder batch-norm gamma/beta.

Deconv kernel orientation: TF's conv2d_transpose stores [h, w, out, in]
and scatters the kernel as is; the models' transposed conv scatters the
spatially flipped [h, w, in, out] kernel, so the import transposes the
last two axes and flips both spatial ones (`tf_deconv_kernel_to_jax`).

Optimizer slots (`Adam`) and tflearn `is_training` variables are skipped,
as the reference's `initialize_pretrained_shallownet` skips them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..bridge import params_from_jax
from ..utils import log


def tf_deconv_kernel_to_jax(k: np.ndarray) -> np.ndarray:
    """[h, w, out, in] TF conv2d_transpose kernel -> the models' HWIO
    scatter kernel (transpose(0, 1, 3, 2) + flip h, w)."""
    return np.ascontiguousarray(np.transpose(k, (0, 1, 3, 2))[::-1, ::-1])


def load_tf_variables(checkpoint_path: str,
                      skip_substrings=("Adam", "is_training", "beta1_power",
                                       "beta2_power")) -> dict:
    """Read every variable from a TF checkpoint -> {name: ndarray}."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("load_tf_variables needs tensorflow to read a TF1 "
                          "checkpoint") from e

    reader = tf.train.load_checkpoint(checkpoint_path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if any(s in name for s in skip_substrings):
            continue
        out[name] = np.asarray(reader.get_tensor(name))
    return out


def _find(variables: dict, *fragments: str) -> Optional[np.ndarray]:
    """The variable whose name contains every fragment (scope prefixes
    vary between the reference's model classes), first by name."""
    matches = [v for n, v in sorted(variables.items())
               if all(f in n for f in fragments)]
    if not matches:
        return None
    return matches[0]


def _req(variables: dict, *fragments: str) -> np.ndarray:
    v = _find(variables, *fragments)
    if v is None:
        raise KeyError(f"variable matching {fragments} missing")
    return v.astype(np.float32)


def shallownet_tree_from_tf(variables: dict) -> dict:
    """ShallowNet variables -> the parameter dict of
    `models/shallownet.init_params` (numpy, the JAX package's keys)."""
    params = {}
    for layer in ("conv1", "conv2", "conv3", "fc1", "fc2"):
        w = _find(variables, "ShallowNet", f"{layer}/", "weights")
        b = _find(variables, "ShallowNet", f"{layer}/", "biases")
        if w is None or b is None:
            raise KeyError(f"ShallowNet/{layer} missing from checkpoint")
        params[f"{layer}_w"] = w.astype(np.float32)
        params[f"{layer}_b"] = b.astype(np.float32)
        log.info("imported ShallowNet/%s %s", layer, w.shape)
    return params


def shallownet_params_from_tf(variables: dict) -> dict[str, torch.Tensor]:
    """ShallowNet variables -> the port's ShallowNet weights (f32 CPU
    tensors, `models/shallownet.apply`'s dict)."""
    return {k: torch.from_numpy(v)
            for k, v in shallownet_tree_from_tf(variables).items()}


_CELL_MAP = {
    "W_z": "GRU_Conv_Wz", "U_z": "GRU_Conv_Uz",
    "W_r": "GRU_Conv_Wr", "U_r": "GRU_Conv_Ur",
    "W": "GRU_Conv_W", "U": "GRU_Conv_U",
}


def grcn_tree_from_tf(variables: dict) -> dict:
    """gaze_grcn variables -> the JAX package's nested parameter tree of
    gaze_grcn (numpy)."""
    params: dict = {"c3d_proj": {}, "cell": {}, "decoder": {}}
    params["c3d_proj"]["proj_c3d_W"] = _req(variables, "proj_c3d_W")
    params["c3d_proj"]["proj_c3d_b"] = _req(variables, "proj_c3d_b")

    for ours, theirs in _CELL_MAP.items():
        # exact-name match, so that Wz does not match W
        candidates = {n: v for n, v in variables.items()
                      if n.split("/")[-1].split(":")[0] == theirs}
        if not candidates:
            raise KeyError(f"cell kernel {theirs} missing")
        params["cell"][ours] = next(iter(sorted(candidates.items())))[1] \
            .astype(np.float32)

    dec = params["decoder"]
    for i, key in enumerate(("up1_w", "up2_w", "up3_w"), start=1):
        dec[key] = tf_deconv_kernel_to_jax(
            _req(variables, f"Upsampling/weight{i}"))
    dec["out_W"] = _req(variables, "out_W")
    dec["out_b"] = _req(variables, "out_b")
    gamma = _find(variables, "batch_normalization", "gamma")
    beta = _find(variables, "batch_normalization", "beta")
    units = dec["up1_w"].shape[2]
    dec["bn_scale"] = (gamma if gamma is not None
                       else np.ones(units)).astype(np.float32)
    dec["bn_offset"] = (beta if beta is not None
                        else np.zeros(units)).astype(np.float32)
    return params


def grcn_params_from_tf(variables: dict) -> dict[str, torch.Tensor]:
    """gaze_grcn variables -> the port's state dict for a gaze_grcn model
    (`model.load_state_dict(...)`), through `bridge.params_from_jax`."""
    return params_from_jax(grcn_tree_from_tf(variables))
