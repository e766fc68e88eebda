"""The port's numpy layer against the JAX package's.

The copied modules (configs, var_order, strategies, colormap) must equal
their originals, and the port's delta codec must write the same bytes as
``ams_tpu.stream.codec.encode_delta(use_native=False)`` and decode them to
the same parameters.  Exact equality throughout: nothing here is float
arithmetic that could legitimately differ.
"""

import numpy as np
import pytest
import torch

from ams_tpu import configs as jconfigs
from ams_tpu.distill import strategies as jstrategies
from ams_tpu.models import var_order as jvar_order
from ams_tpu.stream import codec as jcodec
from ams_tpu.utils import checkpoint as jckpt
from ams_tpu.utils.colormap import colormap as jcolormap
from ams_tpu.utils import metrics as jmetrics

from ams_tpu_torch import configs as tconfigs
from ams_tpu_torch.convert import params_to_numpy
from ams_tpu_torch.distill import strategies as tstrategies
from ams_tpu_torch.models import var_order as tvar_order
from ams_tpu_torch.models.mobilenetv2_deeplab import (
    init_student_params,
    trainable_names,
)
from ams_tpu_torch.stream import codec as tcodec
from ams_tpu_torch.utils import checkpoint as tckpt
from ams_tpu_torch.utils.colormap import colormap as tcolormap
from ams_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def student():
    """Real-width student params (numpy), a 10% coord mask over the
    trainables and a perturbed copy, all from numpy seeds."""
    params = params_to_numpy(init_student_params(3, device="cpu"))
    rng = np.random.RandomState(0)
    train = trainable_names(params)
    masks = {k: rng.rand(*params[k].shape) < 0.1 for k in train}
    moved = dict(params)
    for k in train:
        noise = rng.randn(*params[k].shape).astype(np.float32) * 0.01
        moved[k] = np.where(masks[k], params[k] + noise, params[k])
    stats = {k: params[k] + rng.rand(*params[k].shape).astype(np.float32)
             for k in tvar_order.STATS_ORDER}
    return params, moved, masks, stats


def test_configs_copy_equals_original():
    assert tconfigs.CITYSCAPES_LABELS == jconfigs.CITYSCAPES_LABELS
    assert tconfigs.VOC_LABELS == jconfigs.VOC_LABELS
    assert sorted(tconfigs._REGISTRY) == sorted(jconfigs._REGISTRY)
    for exp in jconfigs._REGISTRY:
        assert tconfigs.num_classes(exp) == jconfigs.num_classes(exp)
        np.testing.assert_array_equal(tconfigs.class_weights(exp),
                                      jconfigs.class_weights(exp))
        np.testing.assert_array_equal(tconfigs.class_indices(exp),
                                      jconfigs.class_indices(exp))


def test_var_order_copy_equals_original():
    assert tvar_order.TRAINABLE_ORDER == jvar_order.TRAINABLE_ORDER
    assert tvar_order.SAVEABLE_ORDER == jvar_order.SAVEABLE_ORDER
    assert tvar_order.STATS_ORDER == jvar_order.STATS_ORDER


def test_colormap_copy_equals_original():
    np.testing.assert_array_equal(tcolormap(), jcolormap())


@pytest.mark.parametrize("strategy", tstrategies.STRATEGIES)
def test_build_mask_equals_original(strategy, student):
    params = student[0]
    shapes = {k: params[k].shape for k in trainable_names(params)}
    assert tstrategies.STRATEGIES == jstrategies.STRATEGIES
    for frac in (0.01, 0.02, 0.05, 0.1, 0.2):
        tm = tstrategies.build_mask(strategy, frac, shapes,
                                    np.random.RandomState(7))
        jm = jstrategies.build_mask(strategy, frac, shapes,
                                    np.random.RandomState(7))
        if jm is None:
            assert tm is None
            continue
        assert list(tm) == list(jm)
        for k in jm:
            np.testing.assert_array_equal(tm[k], jm[k])
        assert tstrategies.mask_coverage(tm) == jstrategies.mask_coverage(jm)


@pytest.mark.parametrize("wire", ["float16", "int8", "int8d"])
@pytest.mark.parametrize("with_stats", [False, True])
def test_encode_delta_bytes_equal(wire, with_stats, student):
    params, moved, masks, stats = student
    kw = dict(strategy="coord_desc_auto", wire_dtype=wire,
              stats=stats if with_stats else None,
              base=params if wire == "int8d" else None)
    ours = tcodec.encode_delta(moved, masks, use_native=False, **kw)
    ref = jcodec.encode_delta(moved, masks, use_native=False, **kw)
    assert ours == ref
    assert tcodec.payload_bits(ours) == jcodec.payload_bits(ref)


def test_encode_delta_full_model_bytes_equal(student):
    moved = student[1]
    assert tcodec.encode_delta(moved, None, strategy="full_model") == \
        jcodec.encode_delta(moved, None, strategy="full_model",
                            use_native=False)
    assert tcodec.delta_order("full_model", present=moved) == \
        jcodec.delta_order("full_model", present=moved)


def test_encode_delta_native_raises(student):
    with pytest.raises(NotImplementedError):
        tcodec.encode_delta(student[1], student[2],
                            strategy="coord_desc_auto", use_native=True)


@pytest.mark.parametrize("wire", ["float16", "int8", "int8d"])
def test_decode_and_apply_delta_agree(wire, student):
    params, moved, masks, stats = student
    base = params if wire == "int8d" else None
    blob = jcodec.encode_delta(moved, masks, strategy="coord_desc_auto",
                               use_native=False, wire_dtype=wire,
                               stats=stats, base=base)
    shapes = {k: v.shape for k, v in params.items()}
    tm, tv = tcodec.decode_delta(blob, shapes, strategy="coord_desc_auto",
                                 wire_dtype=wire, base=base)
    jm, jv = jcodec.decode_delta(blob, shapes, strategy="coord_desc_auto",
                                 wire_dtype=wire, base=base)
    assert list(tm) == list(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k])
        np.testing.assert_array_equal(tv[k], jv[k])
    tout = tcodec.apply_delta(params, tm, tv)
    jout = jcodec.apply_delta(params, jm, jv)
    for k in jout:
        assert tout[k].dtype == jout[k].dtype
        np.testing.assert_array_equal(tout[k], jout[k])


def test_checkpoint_roundtrip_matches_original(tmp_path, student):
    params = student[0]
    path = str(tmp_path / "ckpt.npy")
    jckpt.save_params(path, params)
    tl, jl = tckpt.load_params(path), jckpt.load_params(path)
    assert sorted(tl) == sorted(jl)
    merged_t = tckpt.merge_restore(student[1], tl)
    merged_j = jckpt.merge_restore(student[1], jl)
    for k in merged_j:
        np.testing.assert_array_equal(merged_t[k], merged_j[k])
    npz = str(tmp_path / "snap.npz")
    np.savez(npz, **student[1])
    loaded = tckpt.load_params(npz)
    for k, v in student[1].items():
        np.testing.assert_array_equal(loaded[k], v)


def test_miou_tables_equal_original():
    rng = np.random.RandomState(4)
    cm = rng.randint(0, 50, (6, 6)).astype(np.float32)
    cm[3, :] = 0
    cm[:, 3] = 0
    for kw in ({}, {"nan": True}, {"detailed": True, "population": True}):
        t, j = tmetrics.calculate_miou(cm, **kw), \
            jmetrics.calculate_miou(cm, **kw)
        assert repr(t) == repr(j)
    iou = jmetrics.calculate_miou(cm)
    cw = jconfigs.class_weights(25)
    assert tmetrics.string_class_iou(iou, class_weights=cw) == \
        jmetrics.string_class_iou(iou, class_weights=cw)
