"""PyTorch port of the main-path stencil operators against the JAX
package, on a non-cubic grid, under the channel BCs (periodic x/y, walls
in z) and fully periodic BCs. Tolerance: 1e-6 of each output's scale, as
f32 sums are taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yade_openfoam_coupling_tpu.models.piso import FluidBCs
from yade_openfoam_coupling_tpu.ops import grid as jgrid
from yade_openfoam_coupling_tpu.ops import stencil as jst
from yade_openfoam_coupling_tpu.ops.grid import FaceBC, FieldBC, Grid
from yade_openfoam_coupling_tpu_torch.convert import config_from
from yade_openfoam_coupling_tpu_torch.ops import grid as tgrid
from yade_openfoam_coupling_tpu_torch.ops import stencil as tst

GRID = Grid.box((8, 6, 10), (0.008, 0.009, 0.010))
_NEU = FieldBC.uniform("neumann")
# inlet at x_lo (Dirichlet u), outflow at x_hi (Neumann u): adjust_phi acts
_INOUT = FieldBC(((FaceBC("dirichlet", (0.1, 0.0, 0.0)), FaceBC("neumann")),
                  (FaceBC("periodic"), FaceBC("periodic")),
                  (FaceBC("dirichlet", 0.0), FaceBC("dirichlet", 0.0))))
BCS = {"channel": FluidBCs.channel_z(), "periodic": FluidBCs.periodic()}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    nx, ny, nz = GRID.shape
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "s": r(nx, ny, nz), "v": r(3, nx, ny, nz), "pos": 1.0 + rng.rand(nx, ny, nz).astype(np.float32),
        "phi": (r(nx + 1, ny, nz), r(nx, ny + 1, nz), r(nx, ny, nz + 1)),
        "T": r(3, 3, nx, ny, nz),
    }


def _cases(S, Gm, grid, bcs, a):
    """name -> thunk computing one operator with module S (stencil) and Gm
    (grid) of one package on that package's arrays `a`."""
    ps = lambda f, bc=bcs.p: Gm.pad_scalar(f, bc)  # noqa: E731
    pv = lambda u: Gm.pad_vector(u, bcs.u)  # noqa: E731
    neu = lambda f: Gm.pad_scalar(f, _NEU)  # noqa: E731
    gam = S.face_interp_all_padded(neu(a["pos"]))
    return {
        "pad_vector": lambda: pv(a["v"]),
        "grad_scalar": lambda: S.grad_scalar_padded(ps(a["s"]), grid),
        "curl_from_grad": lambda: S.curl_from_grad(S.grad_vector_padded(pv(a["v"]), grid)),
        "face_interp_all": lambda: S.face_interp_all_padded(neu(a["s"])),
        "flux": lambda: S.flux_padded(pv(a["v"]), grid),
        "div_flux": lambda: S.div_flux(a["phi"], grid),
        "div_phi_vector": lambda: S.div_phi_vector_padded(a["phi"], pv(a["v"]), grid),
        "div_phi_scalar_upwind": lambda: S.div_phi_scalar_padded(
            a["phi"], neu(a["s"]), grid, "upwind"),
        "laplacian_gamma_vector": lambda: S.laplacian_gamma_vector_padded(gam, pv(a["v"]), grid),
        "laplacian_facegamma": lambda: S.laplacian_facegamma_padded(gam, ps(a["s"]), grid),
        "dev2_transpose_stress": lambda: S.dev2_transpose_stress(a["T"], a["pos"]),
        "div_tensor": lambda: S.div_tensor(a["T"], grid, neu),
        "face_grad": lambda: S.face_grad_padded(ps(a["s"]), grid),
        "reconstruct": lambda: S.reconstruct(a["phi"]),
        "constrain_flux": lambda: S.constrain_flux(a["phi"], bcs.u),
        "adjust_phi": lambda: S.adjust_phi(a["phi"], _INOUT, grid),
    }


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


@pytest.mark.parametrize("bname", list(BCS))
@pytest.mark.parametrize("op", list(_cases(jst, jgrid, GRID, BCS["channel"],
                                           {"pos": jnp.ones(GRID.shape)})))
def test_stencil_op_matches_jax(op, bname):
    a = _inputs()
    ja = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v))
          for k, v in a.items()}
    ta = {k: (tuple(torch.as_tensor(x) for x in v) if isinstance(v, tuple) else torch.as_tensor(v))
          for k, v in a.items()}
    ref = _cases(jst, jgrid, GRID, BCS[bname], ja)[op]()
    out = _cases(tst, tgrid, config_from(GRID), config_from(BCS[bname]), ta)[op]()
    refs, outs = _leaves(ref), _leaves(out)
    assert len(refs) == len(outs)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-6 * np.abs(r).max())
