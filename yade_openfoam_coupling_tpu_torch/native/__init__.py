"""The k-d tree cell locator and the CSR binner (port of
`yade_openfoam_coupling_tpu/native/`): `MeshTree` (`nearest`,
`range_query`), `bin_points` and `available`."""

from .bindings import MeshTree, available, bin_points  # noqa: F401
