"""The port's configs, reference state dicts, compact parameter files and PNG
reader against the JAX package's and OpenCV's, on the CPU.

- ``utils/config.py``: a JSON written by either package's ``config_to_dict``
  loads into the other's config with the same fields (the port's sizes and
  neck types are strings, the JAX package's enums of those values).
- ``utils/torch_port.py``: a reference ``AdaptiveScaling`` state dict maps
  to the same parameter tree, leaf for leaf and bit for bit, as
  ``adascale.utils.torch_port.adaptive_scaling_params_from_torch``.
- ``utils/params.py::load_params`` and ``tools/export_params.py``: equal to
  the JAX package's ``load_params`` on the same files.
- ``utils/png.py``: equal bit for bit to ``cv2.imread``.
"""
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from adascale.inference import AdaptiveScalingInferenceConfig as JaxInferenceConfig
from adascale.inference.engine import load_params as jax_load_params
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale.models import AdaptiveScalingNeckHeadType, AdaptiveScalingSize
from adascale.utils.config import config_to_dict as jax_config_to_dict
from adascale.utils.config import load_config as jax_load_config
from adascale.utils.torch_port import adaptive_scaling_params_from_torch as jax_params_from_torch
from adascale_torch import AdaptiveScalingInferenceConfig
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.tools.export_params import flatten_params
from adascale_torch.tools.export_params import main as export_params_main
from adascale_torch.utils.config import config_to_dict, dump_config, load_config
from adascale_torch.utils.params import jax_from_state_dict, load_params
from adascale_torch.utils.png import read_image, write_png
from adascale_torch.utils.torch_port import adaptive_scaling_params_from_torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))


# ----------------------------------------------------------------- configs

JAX_CONFIGS = {
    "tiny_fpn": JaxConfig(size=AdaptiveScalingSize.TINY, neck_head_type=AdaptiveScalingNeckHeadType.FPN),
    "micro_upernext_mask": JaxConfig(
        size=AdaptiveScalingSize.SMALL,
        neck_head_type=AdaptiveScalingNeckHeadType.UPERNEXT,
        precise_enable_char_mask_head=True,
        precise_upsampling_factor=4,
        rough_init_char_height_output_bias=6.5,
        custom_block_channels_and_num_layers=MICRO_SPEC,
    ),
}


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_model_config_json_both_ways(name, tmp_path):
    jax_cfg = JAX_CONFIGS[name]
    path = tmp_path / "model.json"
    path.write_text(json.dumps(jax_config_to_dict(jax_cfg)))
    port = load_config(str(path), AdaptiveScalingConfig)
    assert port.size == jax_cfg.size.value and port.neck_head_type == jax_cfg.neck_head_type.value
    assert config_to_dict(port) == jax_config_to_dict(jax_cfg)
    if jax_cfg.custom_block_channels_and_num_layers is not None:
        assert port.custom_block_channels_and_num_layers == MICRO_SPEC
    # The other way: the port writes, the JAX package reads the same config.
    dump_config(port, tmp_path / "port.json")
    assert jax_load_config(str(tmp_path / "port.json"), JaxConfig) == jax_cfg


def test_inference_config_json_both_ways(tmp_path, monkeypatch):
    jax_cfg = JaxInferenceConfig(
        checkpoint="params.npz", model=JAX_CONFIGS["micro_upernext_mask"], compute_dtype="bfloat16",
        use_pallas_backbone=True, precise_band_recall_center_dist_ratio=0.5, shape_bucket=32,
    )
    port = load_config(json.dumps(jax_config_to_dict(jax_cfg)), AdaptiveScalingInferenceConfig)
    assert isinstance(port.model, AdaptiveScalingConfig)
    written = config_to_dict(port)
    assert written.pop("device") == "cuda"  # the port's own field, at its default
    assert written == jax_config_to_dict(jax_cfg)
    assert jax_load_config(written, JaxInferenceConfig) == jax_cfg
    # None, a dict, and a path with an environment variable in it.
    assert load_config(None, AdaptiveScalingInferenceConfig) == AdaptiveScalingInferenceConfig()
    assert load_config({"shape_bucket": 32}, AdaptiveScalingInferenceConfig).shape_bucket == 32
    dump_config(port, tmp_path / "infer.json")
    monkeypatch.setenv("ADASCALE_TORCH_TEST_DIR", str(tmp_path))
    assert load_config("$ADASCALE_TORCH_TEST_DIR/infer.json", AdaptiveScalingInferenceConfig) == port
    with pytest.raises(TypeError, match="Unknown field"):
        load_config({"no_such_field": 1}, AdaptiveScalingConfig)


# --------------------------------------------------- reference state dicts


def _linear(sd, prefix, leaf):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = leaf["kernel"].T, leaf["bias"]


def _conv(sd, prefix, leaf):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = leaf["kernel"].transpose(3, 2, 0, 1), leaf["bias"]


def _ln(sd, prefix, leaf):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = leaf["scale"], leaf["bias"]


def reference_state_dict(tree, neck, mask_head):
    """The reference model's state dict (its names and layouts) holding the
    leaves of ``tree``, the nested parameter tree: the inverse of the
    mapping under test, written from the reference's module layout."""
    sd = {}
    bb = tree["backbone"]
    _conv(sd, "backbone.stem.0", bb["stem_conv"])
    _ln(sd, "backbone.stem.2", bb["stem_ln"])
    for i in range(len([k for k in bb if k.startswith("stage")])):
        stage = bb[f"stage{i}"]
        for j in range(len([k for k in stage if k.startswith("layer")])):
            layer, lp = stage[f"layer{j}"], f"backbone.blocks.{i}.layers.{j}"
            _conv(sd, f"{lp}.block.0", layer["dwconv"])
            _ln(sd, f"{lp}.block.2", layer["ln"])
            _linear(sd, f"{lp}.block.3", layer["mlp_up"])
            _linear(sd, f"{lp}.block.5", layer["mlp_down"])
            sd[f"{lp}.block_scale"] = layer["block_scale"].reshape(-1, 1, 1)
        _ln(sd, f"backbone.blocks.{i}.ln.1", stage["ln"])
        if "downsample" in stage:
            _conv(sd, f"backbone.blocks.{i}.pconv2x2", stage["downsample"])
    for name in ("rough_neck", "precise_neck"):
        node, p = tree[name], f"{name}."
        levels = len([k for k in node if k.startswith("step1_")])
        if neck == "upernext":
            ppm = f"{p}step1_conv_blocks.{levels}"
            for k in range(len([k for k in node["ppm"] if k.startswith("ap_conv")])):
                _linear(sd, f"{ppm}.ap_conv_blocks.{k}.1.1", node["ppm"][f"ap_conv{k}"]["conv"])
                _ln(sd, f"{ppm}.ap_conv_blocks.{k}.1.2", node["ppm"][f"ap_conv{k}"]["ln"])
            _conv(sd, f"{ppm}.final_conv_block.0", node["ppm"]["final_conv"]["conv"])
            _ln(sd, f"{ppm}.final_conv_block.2", node["ppm"]["final_conv"]["ln"])
        for i in range(levels):
            _linear(sd, f"{p}step1_conv_blocks.{i}.1", node[f"step1_{i}"]["conv"])
            _ln(sd, f"{p}step1_conv_blocks.{i}.2", node[f"step1_{i}"]["ln"])
        for i in range(len([k for k in node if k.startswith("step2_")])):
            _conv(sd, f"{p}step2_conv_blocks.{i}.0", node[f"step2_{i}"]["conv"])
            _ln(sd, f"{p}step2_conv_blocks.{i}.2", node[f"step2_{i}"]["ln"])
    heads = ["rough_char_mask_head", "rough_char_height_head", "precise_char_prob_head",
             "precise_char_up_left_corner_offset_head", "precise_char_corner_angle_head",
             "precise_char_corner_distance_head"] + (["precise_char_mask_head"] if mask_head else [])
    conv3, linear1 = ("step1_conv", "step2_conv") if neck == "fpn" else ("step1_conv3x3", "step2_conv1x1")
    for name in heads:
        head = tree[name]
        p = f"{name}.0." if name in ("rough_char_height_head", "precise_char_corner_distance_head") else f"{name}."
        _conv(sd, f"{p}{conv3}.0", head["step1"]["conv"])
        _ln(sd, f"{p}{conv3}.2", head["step1"]["ln"])
        _linear(sd, f"{p}{linear1}.1", head["step2"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _random_tree(neck, mask_head, seed=0):
    """A parameter tree of the micro model with random leaves (nothing left
    at its initial value, so a swapped leaf shows)."""
    config = AdaptiveScalingConfig(neck_head_type=neck, precise_enable_char_mask_head=mask_head,
                                   custom_block_channels_and_num_layers=MICRO_SPEC)
    gen = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in AdaptiveScaling(config).state_dict().items()}
    return jax_from_state_dict(sd)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        else:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape and g.dtype == w.dtype, (f"{path}/{key}", g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{key}")


@pytest.mark.parametrize("neck", ["fpn", "upernext"])
@pytest.mark.parametrize("mask_head", [False, True])
def test_reference_state_dict_mapping_matches_jax(neck, mask_head):
    tree = _random_tree(neck, mask_head)
    sd = reference_state_dict(tree, neck, mask_head)
    got = adaptive_scaling_params_from_torch(sd, neck, mask_head)
    _assert_trees_equal(got, jax_params_from_torch(sd, neck, mask_head))
    _assert_trees_equal(got, tree)  # and it inverts the reference layout


@pytest.mark.parametrize("neck", ["fpn", "upernext"])
def test_reference_model_state_dict_matches_jax(neck):
    """On the reference model's own state dict, as tests/test_parity_chain.py
    builds it (runs where the reference checkout is present)."""
    from test_parity_chain import REFERENCE_PATH, _build_micro_torch

    if not os.path.isdir(REFERENCE_PATH):
        pytest.skip("no reference checkout")
    sd = _build_micro_torch(neck).state_dict()
    got = adaptive_scaling_params_from_torch(sd, neck)
    _assert_trees_equal(got, jax_params_from_torch(sd, neck))
    config = AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=MICRO_SPEC)
    from adascale_torch.utils.params import state_dict_from_jax

    AdaptiveScaling(config).load_state_dict(state_dict_from_jax(got), strict=True)


# ---------------------------------------------- load_params, export_params


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_params_state_dict_file_matches_jax(wrapped, tmp_path):
    tree = _random_tree("upernext", True, seed=1)
    sd = reference_state_dict(tree, "upernext", True)
    path = tmp_path / "reference.pt"
    torch.save({"model_jit_state_dict": sd, "epoch_idx": 3} if wrapped else sd, path)
    port_cfg = AdaptiveScalingConfig(neck_head_type="upernext", precise_enable_char_mask_head=True,
                                     custom_block_channels_and_num_layers=MICRO_SPEC)
    jax_cfg = JaxConfig(neck_head_type=AdaptiveScalingNeckHeadType.UPERNEXT, precise_enable_char_mask_head=True,
                        custom_block_channels_and_num_layers=MICRO_SPEC)
    got = load_params(str(path), port_cfg)
    _assert_trees_equal(got, jax_load_params(str(path), jax_cfg))
    _assert_trees_equal(got, tree)


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_export_params_matches_jax_load_params(dtype, tmp_path):
    """tools/export_params from a reference state dict -> flat .npz; the
    port's load_params and the JAX package's read it to the same tree (the
    counterpart of tests/test_tools.py::test_export_params_roundtrip)."""
    tree = _random_tree("fpn", False, seed=2)
    torch.save(reference_state_dict(tree, "fpn", False), tmp_path / "reference.pt")
    model_json = tmp_path / "model.json"
    dump_config(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC), model_json)
    out = tmp_path / "params.npz"
    export_params_main(["--checkpoint", str(tmp_path / "reference.pt"), "--out", str(out),
                        "--dtype", dtype, "--model-config", str(model_json)])
    with np.load(out) as flat:
        assert set(flat.files) == set(flatten_params(tree))
        assert {flat[k].dtype for k in flat.files} == {np.dtype(dtype)}
    got = load_params(str(out), AdaptiveScalingConfig())
    _assert_trees_equal(got, jax_load_params(str(out), JaxConfig()))
    rounded = {k: v.astype(dtype).astype(np.float32) for k, v in flatten_params(tree).items()}
    assert all(np.array_equal(v, rounded[k]) for k, v in flatten_params(got).items())


def test_load_params_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(NotImplementedError, match="item 9.3"):
        load_params(str(tmp_path), AdaptiveScalingConfig())
    with pytest.raises(NotImplementedError, match="item 9.3"):
        export_params_main(["--checkpoint", str(tmp_path), "--out", str(tmp_path / "p.npz")])


# ---------------------------------------------------------------------- PNG


def _page(h=37, w=53, seed=0):
    """A page-like RGB image: smooth gradients (which the prediction filters
    reduce to small residues) under noise and a few saturated strokes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (h + w)], axis=-1)
    image = base + rng.normal(0, 12, (h, w, 3))
    image[h // 3, :] = 0
    image[:, w // 2] = 255
    return np.clip(image, 0, 255).astype(np.uint8)


def _encode(pixels, filter_type, interlace=0):
    """A PNG of (H, W, C) uint8 with every row under ``filter_type`` (the
    forward filters, vectorised: each predicts from unfiltered bytes)."""
    h, w, c = pixels.shape
    raw = pixels.reshape(h, w * c).astype(np.int32)
    left = np.concatenate([np.zeros((h, c), np.int32), raw[:, :-c]], axis=1)
    up = np.concatenate([np.zeros((1, w * c), np.int32), raw[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((h, c), np.int32), up[:, :-c]], axis=1)
    if filter_type == 0:
        pred = np.zeros_like(raw)
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = ((raw - pred) % 256).astype(np.uint8)
    body = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def _cv2_rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[:, :, ::-1]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_equals_cv2_on_files_cv2_writes(channels, tmp_path):
    image = _page()
    if channels == 1:
        pixels = image[:, :, 0]
    elif channels == 4:
        pixels = np.concatenate([image, image[:, :, :1] // 2 + 7], axis=-1)
    else:
        pixels = image
    path = tmp_path / "page.png"
    assert cv2.imwrite(str(path), pixels)  # OpenCV's channel order; the reader returns RGB
    np.testing.assert_array_equal(read_image(str(path)), _cv2_rgb(path))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_equals_cv2_on_each_filter(filter_type, channels, tmp_path):
    image = _page(seed=filter_type)
    pixels = {1: image[:, :, :1], 3: image, 4: np.concatenate([image, image[:, :, 1:2]], axis=-1)}[channels]
    path = tmp_path / "page.png"
    path.write_bytes(_encode(pixels, filter_type))
    want = _cv2_rgb(path)
    np.testing.assert_array_equal(read_image(str(path)), want)
    # cv2 reads BGR: the file's RGB comes back as RGB.
    np.testing.assert_array_equal(want, np.repeat(pixels, 3, axis=2) if channels == 1 else pixels[:, :, :3])


def test_png_writer_and_npz_pages(tmp_path):
    image = _page(64, 48, seed=5)
    write_png(str(tmp_path / "page.png"), image)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "page.png"), image)
    np.testing.assert_array_equal(read_image(str(tmp_path / "page.png")), image)
    np.savez(tmp_path / "page.npz", image=image)
    np.testing.assert_array_equal(read_image(str(tmp_path / "page.npz")), image)


def test_png_reader_refuses_jpeg_16_bit_interlaced_and_gray_alpha(tmp_path):
    image = _page()
    assert cv2.imwrite(str(tmp_path / "page.jpg"), image)
    with pytest.raises(NotImplementedError, match="JPEG"):
        read_image(str(tmp_path / "page.jpg"))
    assert cv2.imwrite(str(tmp_path / "deep.png"), image.astype(np.uint16) * 257)
    with pytest.raises(NotImplementedError, match="16-bit"):
        read_image(str(tmp_path / "deep.png"))
    (tmp_path / "interlaced.png").write_bytes(_encode(image, 0, interlace=1))
    with pytest.raises(NotImplementedError, match="interlaced"):
        read_image(str(tmp_path / "interlaced.png"))
    (tmp_path / "gray_alpha.png").write_bytes(_encode(image[:, :, :2], 0))
    with pytest.raises(NotImplementedError, match="colour type 4"):
        read_image(str(tmp_path / "gray_alpha.png"))
