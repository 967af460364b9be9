"""Weight carriers: JAX-package params -> this port's ``state_dict``s.

``flax_params_to_state_dict`` carries ``TrackerNet``'s DroidNet params;
``decoder_params_to_state_dict`` the mapper's ``PointDecoders`` params.

The JAX package keeps its DroidNet params as a nested dict (flax layout:
HWIO conv kernels, and three double-width convs that fuse reference
siblings along the output channels: ``gru.convzr`` = convz|convr,
``gru.convzr_glo`` = convz_glo|convr_glo, ``dw_1`` = delta.0|weight.0).
This port's modules keep the reference checkpoint's names and OIHW
kernels, so the carrier transposes each kernel and splits the fused ones.
It is the inverse of the JAX package's ``nets/import_torch.py`` table, kept
here as its own copy. Random weights made on either side therefore load on
the other, and parity tests need neither droid.pth nor the reference code.
"""

from typing import Dict

import numpy as np
import torch


def _plain_table() -> Dict[str, tuple]:
    """torch prefix -> flax param path (one conv each)."""
    m = {}
    for enc in ("fnet", "cnet"):
        m[f"{enc}.conv1"] = (enc, "conv1")
        m[f"{enc}.conv2"] = (enc, "conv2")
        for layer in (1, 2, 3):
            for blk in (0, 1):
                base = f"{enc}.layer{layer}.{blk}"
                path = (enc, f"layer{layer}_{blk}")
                m[f"{base}.conv1"] = path + ("conv1",)
                m[f"{base}.conv2"] = path + ("conv2",)
                m[f"{base}.downsample.0"] = path + ("downsample",)
    u = "update"
    m[f"{u}.corr_encoder.0"] = (u, "corr_enc_1")
    m[f"{u}.corr_encoder.2"] = (u, "corr_enc_2")
    m[f"{u}.flow_encoder.0"] = (u, "flow_enc_1")
    m[f"{u}.flow_encoder.2"] = (u, "flow_enc_2")
    m[f"{u}.weight.2"] = (u, "weight_2")
    m[f"{u}.delta.2"] = (u, "delta_2")
    for g in ("convq", "w", "convq_glo"):
        m[f"{u}.gru.{g}"] = (u, "gru", g)
    m[f"{u}.agg.conv1"] = (u, "agg", "conv1")
    m[f"{u}.agg.conv2"] = (u, "agg", "conv2")
    m[f"{u}.agg.eta.0"] = (u, "agg", "eta")
    m[f"{u}.agg.upmask.0"] = (u, "agg", "upmask")
    return m


def _fused_table() -> Dict[tuple, tuple]:
    """flax double-width conv path -> torch prefixes, in output order."""
    u = "update"
    return {
        (u, "gru", "convzr"): (f"{u}.gru.convz", f"{u}.gru.convr"),
        (u, "gru", "convzr_glo"): (f"{u}.gru.convz_glo",
                                   f"{u}.gru.convr_glo"),
        (u, "dw_1"): (f"{u}.delta.0", f"{u}.weight.0"),
    }


def _leaf(params, path):
    node = params
    for p in path:
        if p not in node:
            return None
        node = node[p]
    return node


def flax_params_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``TrackerNet.params`` of the JAX package (nested dict of arrays,
    with or without the top-level "params" key) -> DroidNet state_dict."""
    params = variables.get("params", variables)
    state = {}
    for prefix, path in _plain_table().items():
        node = _leaf(params, path)
        if node is None:
            continue
        state[f"{prefix}.weight"] = np.transpose(
            np.asarray(node["kernel"], np.float32), (3, 2, 0, 1))
        state[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)
    for path, prefixes in _fused_table().items():
        node = _leaf(params, path)
        if node is None:
            continue
        kernels = np.split(np.asarray(node["kernel"], np.float32),
                           len(prefixes), axis=-1)
        biases = np.split(np.asarray(node["bias"], np.float32),
                          len(prefixes))
        for prefix, k, b in zip(prefixes, kernels, biases):
            state[f"{prefix}.weight"] = np.transpose(k, (3, 2, 0, 1))
            state[f"{prefix}.bias"] = b
    return {k: torch.from_numpy(np.array(v))
            for k, v in state.items()}


def decoder_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``PointDecoders`` params (nested dict of arrays,
    with or without the top-level "params" key) -> the port's
    ``mapping.decoders.PointDecoders`` state_dict. The port names its
    modules after the flax tree, so a Dense ``kernel`` (in, out) becomes
    ``weight`` (out, in) and ``bias`` and the Fourier ``B`` keep their
    names and layouts."""
    params = params.get("params", params)
    state = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + (key,))
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            state[".".join(prefix + (key,))] = torch.tensor(arr)

    walk(params, ())
    return state
