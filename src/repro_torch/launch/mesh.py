"""Production grids and the card's constants (the port of
``repro.launch.mesh``).

The reference's production meshes are 16 x 16 ``("data", "model")`` and
2 x 16 x 16 ``("pod", "data", "model")`` TPU meshes.  The port reads them
as grids of H100s and builds no process group for them: a :class:`Grid`
is a plain description (axis names and sizes) that the dry run
(``launch.dryrun``) and ``sharding.layout.choose_worker_axes`` read the
way the reference reads a ``jax.sharding.Mesh`` (``axis_names``,
``shape[axis]``, ``devices.size``).

The roofline divides by the card's rates: NVIDIA's H100 SXM data sheet,
dense (the sheet's sparse tensor-core rates halved).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# H100 SXM hardware constants used by the roofline (per card)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, TF32 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 on the CUDA cores (the port's matmuls: TF32 off)
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s each way (NVLink 4, 900 GB/s both ways)
HBM_BYTES = 80e9                # device memory


def card_rates(name: str):
    """(memory bytes/s, float32 non-tensor flop/s, bf16 dense tensor-core
    flop/s, TF32 dense tensor-core flop/s) from NVIDIA's data sheets for
    the card present (``torch.cuda.get_device_name``; the sheets' sparse
    tensor rates halved)."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12, 378e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12, 835e12, 418e12
    if "H200" in name:
        return 4.8e12, 67e12, 989e12, 495e12
    return HBM_BW, PEAK_FLOPS_F32, PEAK_FLOPS_BF16, PEAK_FLOPS_TF32  # H100 SXM


@dataclass(frozen=True)
class Grid:
    """A grid of cards: axis names and their sizes, nothing built."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} "
                             f"differ in length")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Cards in the grid."""
        return math.prod(self.sizes)


def make_production_grid(*, multi_pod: bool = False) -> Grid:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return Grid(("pod", "data", "model"), (2, 16, 16))
    return Grid(("data", "model"), (16, 16))

