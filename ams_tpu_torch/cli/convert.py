#!/usr/bin/env python
"""Convert checkpoints between formats, flag-compatible with
``ams_tpu/cli/convert.py`` (``ams-convert``).

The port loads .npy/.npz dicts, TF checkpoint prefixes and Orbax
directories directly (``utils.checkpoint.load_any``), so conversion is
never required; this tool writes standalone artifacts: a portable .npz of
a TF1 checkpoint (``model.index`` + ``model.data-*``, read without
TensorFlow), an Orbax directory (the default for a destination that ends
in neither .npz nor .npy, as JAX's; written without orbax, in the
per-array zarr layout that orbax reads), or the BN-folded deployment dict
(``models.frozen.fold_student``).  Flags are
JAX's, plus ``--device``: with ``--fold`` the loaded dict goes to the
GPU (the default) and ``fold_student`` returns the deployment dict there,
as JAX's lands on its default device (the fold's arithmetic is numpy on
the host in both packages); ``--device cpu`` keeps it on the host.

Examples:
    python -m ams_tpu_torch.cli.convert ckpts/model out/student.npz
    python -m ams_tpu_torch.cli.convert ckpts/model out/deploy.npz --fold
    python -m ams_tpu_torch.cli.convert run.npy out/student --format npy \
        --device cpu
    python -m ams_tpu_torch.cli.convert ckpts/model out/orbax_dir
"""

import argparse

import numpy as np

from ams_tpu_torch.utils import checkpoint as ckpt
from ams_tpu_torch.utils.platform import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="TF checkpoint prefix, .npy/.npz, or orbax dir")
    p.add_argument("dst", help="output path (.npz/.npy or orbax dir)")
    p.add_argument("--fold", action="store_true",
                   help="emit the BN-folded deployment dict (weights with "
                        "/folded_bias companions; no BN params)")
    p.add_argument("--format", choices=["npz", "npy", "orbax"], default=None,
                   help="output format (default: from dst extension)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the folded dict is placed (default: the GPU)")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    fmt = a.format
    if fmt is None:
        fmt = "npy" if a.dst.endswith(".npy") else (
            "npz" if a.dst.endswith(".npz") else "orbax")
    device = resolve_device(a.device)
    params = ckpt.load_any(a.src)
    print("loaded %d variables from %s" % (len(params), a.src))
    if a.fold:
        from ams_tpu_torch.convert import params_from_numpy, params_to_numpy
        from ams_tpu_torch.models.frozen import fold_student

        params = params_to_numpy(fold_student(
            params_from_numpy(params, device)))
        print("folded -> %d deployment variables" % len(params))

    dst = a.dst
    if fmt == "orbax":
        ckpt.save_orbax(dst, params)
    elif fmt == "npy":
        if not dst.endswith(".npy"):
            dst += ".npy"
        ckpt.save_params(dst, params)
    else:
        if not dst.endswith(".npz"):
            dst += ".npz"
        np.savez(dst, **{k: np.asarray(v) for k, v in params.items()})
    print("wrote %s (%s)" % (dst, fmt))


if __name__ == "__main__":
    main()
