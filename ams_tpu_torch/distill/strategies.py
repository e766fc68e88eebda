"""Parameter-subset ("coordinate descent") selection strategies.

The reference offers six strategies (run.py:49-55) deciding which subset of
the student's parameters a training round may move — and hence what ships on
the downlink:

- ``full_model``       — no mask.
- ``coord_desc_auto``  — gradient-guided: after one full Adam step, keep the
  top ``coord_frac`` fraction of parameters by |delta| (computed ON DEVICE in
  our train step, see train_step.py; the reference pulls every parameter to
  host, SemanticNetwork.py:263-288).
- ``coord_desc_last/first/both`` — hand-derived per-layer recipes for
  coord_frac in {0.01, 0.02, 0.05, 0.1, 0.2}: named layers fully trainable
  plus one Bernoulli-sampled partial layer to hit the exact budget
  (SemanticNetwork.py:310-653).  Transcribed below as data.
- ``coord_desc_rand``  — uniform Bernoulli(coord_frac) over all parameters.

``build_mask`` returns a {name: bool ndarray} dict over the trainable
parameters, or None for full_model / auto (auto's mask is data produced by
the jitted round).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

STRATEGIES = ("full_model", "coord_desc_auto", "coord_desc_last",
              "coord_desc_first", "coord_desc_both", "coord_desc_rand")

_FIRST9 = ["/Conv/"] + ["/expanded_conv/"] + [
    "/expanded_conv_%d/" % i for i in range(1, 9)]

# (strategy, coord_frac) -> dict(substr=[...], exact=[...], partial={key: p}).
# 'substr' entries select every trainable var whose name contains the
# fragment; 'exact' names single vars; 'partial' draws Bernoulli(p) masks.
_RECIPES = {
    ("coord_desc_last", 0.1): dict(
        substr=[],
        exact=["aspp0/BatchNorm/gamma", "aspp0/BatchNorm/beta",
               "concat_projection/weights", "concat_projection/BatchNorm/gamma",
               "concat_projection/BatchNorm/beta", "logits/semantic/weights",
               "logits/semantic/biases"],
        partial={"aspp0/weights": 0.90728}),
    ("coord_desc_first", 0.1): dict(
        substr=_FIRST9,
        exact=["MobilenetV2/expanded_conv_9/expand/weights",
               "MobilenetV2/expanded_conv_9/expand/BatchNorm/gamma",
               "MobilenetV2/expanded_conv_9/expand/BatchNorm/beta"],
        partial={"MobilenetV2/expanded_conv_9/depthwise/depthwise_weights":
                 0.25231}),
    ("coord_desc_both", 0.1): dict(
        substr=_FIRST9[:8] + ["logits/semantic/"],
        exact=["MobilenetV2/expanded_conv_7/expand/weights",
               "MobilenetV2/expanded_conv_7/expand/BatchNorm/gamma",
               "MobilenetV2/expanded_conv_7/expand/BatchNorm/beta",
               "MobilenetV2/expanded_conv_7/depthwise/depthwise_weights",
               "concat_projection/BatchNorm/gamma",
               "concat_projection/BatchNorm/beta"],
        partial={"MobilenetV2/expanded_conv_7/depthwise/BatchNorm/gamma":
                 0.80208,
                 "concat_projection/weights": 0.76490}),
    ("coord_desc_last", 0.05): dict(
        substr=["logits/semantic/"],
        exact=["concat_projection/BatchNorm/gamma",
               "concat_projection/BatchNorm/beta"],
        partial={"concat_projection/weights": 0.76490}),
    ("coord_desc_first", 0.05): dict(
        substr=_FIRST9[:8],
        exact=["MobilenetV2/expanded_conv_7/expand/weights",
               "MobilenetV2/expanded_conv_7/expand/BatchNorm/gamma",
               "MobilenetV2/expanded_conv_7/expand/BatchNorm/beta",
               "MobilenetV2/expanded_conv_7/depthwise/depthwise_weights"],
        partial={"MobilenetV2/expanded_conv_7/depthwise/BatchNorm/gamma":
                 0.80208}),
    ("coord_desc_both", 0.05): dict(
        substr=_FIRST9[:6] + ["/expanded_conv_5/expand/",
                              "/expanded_conv_5/depthwise/",
                              "logits/semantic/"],
        exact=["concat_projection/BatchNorm/gamma",
               "concat_projection/BatchNorm/beta"],
        partial={"MobilenetV2/expanded_conv_5/project/weights": 0.42285,
                 "concat_projection/weights": 0.36187}),
    ("coord_desc_last", 0.01): dict(
        substr=["logits/semantic/", "concat_projection/BatchNorm/"],
        exact=[],
        partial={"concat_projection/weights": 0.12005}),
    ("coord_desc_first", 0.01): dict(
        substr=_FIRST9[:4] + ["/expanded_conv_3/depthwise/",
                              "/expanded_conv_3/expand/"],
        exact=[],
        partial={"MobilenetV2/expanded_conv_3/project/weights": 0.00217}),
    ("coord_desc_both", 0.01): dict(
        substr=_FIRST9[:3] + ["logits/semantic/",
                              "concat_projection/BatchNorm/"],
        exact=["MobilenetV2/expanded_conv_2/expand/weights",
               "MobilenetV2/expanded_conv_2/expand/BatchNorm/gamma"],
        partial={"MobilenetV2/expanded_conv_2/expand/BatchNorm/beta": 0.03472,
                 "concat_projection/weights": 0.03944}),
    ("coord_desc_last", 0.2): dict(
        substr=["logits/semantic/", "concat_projection/", "aspp0/",
                "image_pooling/",
                "MobilenetV2/expanded_conv_16/project/BatchNorm"],
        exact=[],
        partial={"MobilenetV2/expanded_conv_16/project/weights": 0.39270}),
    ("coord_desc_first", 0.2): dict(
        substr=_FIRST9 + ["/expanded_conv_9/", "/expanded_conv_10/",
                          "/expanded_conv_11/expand/",
                          "/expanded_conv_11/depthwise/"],
        exact=[],
        partial={"MobilenetV2/expanded_conv_11/project/weights": 0.97367}),
    ("coord_desc_both", 0.2): dict(
        substr=_FIRST9 + ["concat_projection/", "aspp0/BatchNorm/",
                          "logits/semantic/"],
        exact=["MobilenetV2/expanded_conv_9/expand/weights",
               "MobilenetV2/expanded_conv_9/expand/BatchNorm/gamma",
               "MobilenetV2/expanded_conv_9/expand/BatchNorm/beta"],
        partial={"MobilenetV2/expanded_conv_9/depthwise/depthwise_weights":
                 0.25231,
                 "aspp0/weights": 0.90728}),
    ("coord_desc_last", 0.02): dict(
        substr=["logits/semantic/", "concat_projection/BatchNorm/"],
        exact=[],
        partial={"concat_projection/weights": 0.7187}),
    ("coord_desc_first", 0.02): dict(
        substr=_FIRST9[:6],
        exact=[],
        partial={"MobilenetV2/expanded_conv_5/expand/weights": 0.7367}),
    ("coord_desc_both", 0.02): dict(
        substr=_FIRST9[:4] + ["/expanded_conv_3/depthwise/",
                              "/expanded_conv_3/expand/", "logits/semantic/",
                              "concat_projection/BatchNorm/"],
        exact=[],
        partial={"MobilenetV2/expanded_conv_3/project/weights": 0.00217,
                 "concat_projection/weights": 0.12005}),
}


def build_mask(strategy: str, coord_frac: float,
               trainable_shapes: Dict[str, tuple],
               rng: Optional[np.random.RandomState] = None,
               ) -> Optional[Dict[str, np.ndarray]]:
    """Host-side mask construction for the fixed strategies.

    Returns None for full_model and coord_desc_auto (full: no mask;
    auto: the jitted round computes the mask on device at iteration 0).
    """
    if strategy not in STRATEGIES:
        raise NameError("train_strategy %s is not implemented." % strategy)
    if strategy in ("full_model", "coord_desc_auto"):
        return None
    rng = rng or np.random.RandomState()
    if strategy == "coord_desc_rand":
        return {k: rng.choice([True, False], size=shape,
                              p=[coord_frac, 1 - coord_frac])
                for k, shape in trainable_shapes.items()}

    recipe = _RECIPES.get((strategy, round(coord_frac, 4)))
    if recipe is None:
        raise NameError(
            "train_strategy %s with coord_frac %s is not implemented."
            % (strategy, coord_frac))
    mask = {}
    for k, shape in trainable_shapes.items():
        if any(s in k for s in recipe["substr"]) or k in recipe["exact"]:
            mask[k] = np.ones(shape, dtype=bool)
        elif k in recipe["partial"]:
            p = recipe["partial"][k]
            mask[k] = rng.choice([True, False], size=shape, p=[p, 1 - p])
        else:
            mask[k] = np.zeros(shape, dtype=bool)
    return mask


def mask_coverage(mask: Dict[str, np.ndarray]):
    """(total_params, selected_params) — the printed fraction in the
    reference's 'Using ... mode, Training x% of variables' logs."""
    total = sum(int(np.prod(v.shape)) for v in mask.values())
    sel = sum(int(v.sum()) for v in mask.values())
    return total, sel
