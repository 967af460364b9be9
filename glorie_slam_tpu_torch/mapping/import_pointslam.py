"""Load the pretrained Point-SLAM geometry decoder (``middle_fine.pt``).

Counterpart of ``glorie_slam_tpu/mapping/import_pointslam.py`` (reference
src/mapper.py:105-121): the checkpoint's ``model`` dict is filtered to its
decoder keys, the ``coarse_decoder.`` entries are merged into the geometry
decoder, and keys that do not exist or do not match in shape are skipped
(``strict=False``). The port's ``MLPGeometry`` keeps PyTorch's (out, in)
Linear layout, so weights are copied as they are, without a transpose.
"""

from typing import Dict

import torch


def _strip_decoder_keys(model_state: Dict[str, torch.Tensor]):
    """-> (middle, fine): the coarse and fine decoders' entries with their
    15- and 13-character prefixes cut, as the reference cuts them."""
    middle, fine = {}, {}
    for key, val in model_state.items():
        if "decoder" in key and "encoder" not in key:
            if "coarse" in key:
                middle[key[15:]] = val
            elif "fine" in key:
                fine[key[13:]] = val
    return middle, fine


def _port_key(key):
    """A reference MLP_geometry key -> the port's geo_decoder key, or None."""
    parts = key.split(".")
    if parts[0] in ("pts_linears", "fc_c") and len(parts) == 3:
        return f"geo_decoder.{parts[0]}_{parts[1]}.{parts[2]}"
    if parts[0] == "output_linear" and len(parts) == 2:
        return f"geo_decoder.output_linear.{parts[1]}"
    if parts[0] == "embedder" and parts[-1] == "_B":
        return "geo_decoder.embedder.B"
    return None


def merge_geo_decoder(state_dict, middle):
    """Merge the reference geometry decoder's weights into a copy of the
    port's ``PointDecoders`` state_dict -> (merged, number loaded)."""
    out = {k: v.clone() for k, v in state_dict.items()}
    n_loaded = 0
    for key, val in middle.items():
        name = _port_key(key)
        if name in out and out[name].shape == val.shape:
            out[name] = val.to(out[name].dtype).clone()
            n_loaded += 1
    return out, n_loaded


def load_pointslam_geo_decoder(path, state_dict):
    """``middle_fine.pt`` -> ``state_dict`` with its geometry decoder
    merged. The checkpoint holds more than tensors, so it is unpickled in
    full (``weights_only=False``): load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    middle, _fine = _strip_decoder_keys(ckpt["model"])
    merged, _ = merge_geo_decoder(state_dict, middle)
    return merged
