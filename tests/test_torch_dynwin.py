"""Kernel B7's plain version against the JAX package's prototype
`scripts/proto_dynwin.py`, whose Pallas kernel runs unchanged in interpret
mode: the script's own inputs and outputs are recorded at `pallas_call`,
then fed to the port's `stage_planes` on the CPU."""

import importlib.util
import sys
from pathlib import Path

import jax.experimental.pallas as pallas
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu_torch.kernels import LAUNCHES
from yade_openfoam_coupling_tpu_torch.scripts import proto_dynwin as tdw

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "proto_dynwin.py"


@pytest.fixture(scope="module")
def recorded():
    """Run the JAX script's main() with --cpu; record each pallas_call's
    `dynamic` flag, inputs (nch, dat) and output."""
    spec = importlib.util.spec_from_file_location("jax_proto_dynwin", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    real = pallas.pallas_call

    def recording(kernel, **kw):
        fn = real(kernel, **kw)

        def run(*args):
            out = fn(*args)
            calls.append((kernel.keywords["dynamic"], [np.array(a) for a in args],
                          np.array(out)))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", recording)
        mp.setattr(sys, "argv", [str(SCRIPT), "--cpu"])
        mod.main()
    return calls


def test_script_inputs_are_the_ports(recorded):
    """The port's `prototype_inputs` are the script's own."""
    assert [c[0] for c in recorded] == [False, True]
    dat, nch = tdw.prototype_inputs()
    for _, (j_nch, j_dat), _ in recorded:
        np.testing.assert_array_equal(j_dat, dat)
        np.testing.assert_array_equal(j_nch, nch)


@pytest.mark.parametrize("dynamic", [False, True])
def test_stage_planes_matches_pallas(recorded, dynamic):
    """Port vs the Pallas kernel within 1e-6 of the output's scale (f32 sums
    of the same bf16-rounded values in another order); dynamic equals
    static exactly on each side."""
    by_flag = {flag: (args, out) for flag, args, out in recorded}
    (j_nch, j_dat), ref = by_flag[dynamic]
    np.testing.assert_array_equal(by_flag[False][1], by_flag[True][1])
    dat, nch = torch.as_tensor(j_dat), torch.as_tensor(j_nch)
    out = tdw.stage_planes(dat, nch, tdw.NY, tdw.NZ, tdw.W_CHUNK, dynamic)
    assert LAUNCHES["yofc_dynwin_staging"] == 0           # CPU: the plain version
    assert out.shape == ref.shape == (8, tdw.NY, tdw.NZ)
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(out.numpy() - ref).max() <= 1e-6 * scale
    other = tdw.stage_planes(dat, nch, tdw.NY, tdw.NZ, tdw.W_CHUNK, not dynamic)
    assert torch.equal(out, other)
    # planes with no live rows stay zero, and every z column is the same
    assert not out[[0, 3, 5, 6]].any()
    assert torch.equal(out, out[:, :, :1].expand_as(out))


def test_dynamic_bound_cuts_the_rows():
    """With rows past the dynamic bound that do match, dynamic and static
    differ by exactly those rows; bounds clamp to [0, W / w_chunk]; the
    wrapper refuses what the kernel does not take; main() passes on the
    CPU."""
    rng = np.random.RandomState(5)
    dat = np.stack([rng.randn(3, 64), rng.randint(0, 4, (3, 64))], 1).astype(np.float32)
    dat = torch.as_tensor(dat)
    nch = torch.tensor([1, -3, 9], dtype=torch.int32)
    dyn = tdw.stage_planes(dat, nch, 4, 2, 16, dynamic=True)
    full = tdw.stage_planes(dat, nch, 4, 2, 16, dynamic=False)
    assert torch.equal(dyn[2], full[2]) and not dyn[1].any()
    cut = dat.clone()
    cut[0, 1, 16:] = -1.0
    assert torch.equal(dyn[0], tdw.stage_planes(cut, nch, 4, 2, 16, dynamic=False)[0])
    with pytest.raises(ValueError, match="multiple"):
        tdw.stage_planes(dat, nch, 4, 2, 24, dynamic=True)
    with pytest.raises(ValueError, match="nch"):
        tdw.stage_planes(dat, nch.long(), 4, 2, 16, dynamic=True)
    assert tdw.main(["--device", "cpu"]) == 0
