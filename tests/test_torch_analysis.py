"""The port's analytic FLOP / HBM-byte model (``repro_torch.analysis.
flops``) against the JAX package's: every count equal, exactly, for
every arch x shape of the JAX package's registry (the port's own
archs have no reference to equal), with 1 and 4 microbatches and on 1
and 256 devices."""

import itertools

import pytest

import repro.analysis.flops as ref_flops
import repro.configs as ref_configs
import repro_torch.analysis.flops as port_flops
import repro_torch.configs as port_configs
from repro_torch.configs.base import SHAPES

CELLS = list(itertools.product(ref_configs.ARCH_IDS, sorted(SHAPES)))


def configs(arch, shape):
    return (port_configs.get_config(arch), SHAPES[shape],
            ref_configs.get_config(arch), ref_configs.SHAPES[shape])


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("microbatches", [1, 4])
def test_cell_flops_equal_reference(arch, shape, microbatches):
    cfg, shp, rcfg, rshp = configs(arch, shape)
    got = port_flops.cell_flops(cfg, shp, microbatches=microbatches)
    want = ref_flops.cell_flops(rcfg, rshp, microbatches=microbatches)
    assert got.total == want.total
    assert got.model_flops == want.model_flops
    assert got.breakdown == want.breakdown
    assert got.useful_ratio == want.useful_ratio


@pytest.mark.parametrize("arch,shape", CELLS)
@pytest.mark.parametrize("n_devices", [1, 256])
def test_cell_hbm_bytes_equal_reference(arch, shape, n_devices):
    cfg, shp, rcfg, rshp = configs(arch, shape)
    assert port_flops.cell_hbm_bytes(cfg, shp, n_devices) == \
        ref_flops.cell_hbm_bytes(rcfg, rshp, n_devices)


def test_smoke_train_cell_counts_remat():
    """remat="full" adds one forward to the backward's two (bwd_mult 4);
    "none" leaves 3."""
    cfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    shape = SHAPES["train_4k"]
    full = port_flops.cell_flops(cfg, shape, microbatches=1)
    none = port_flops.cell_flops(cfg.with_(remat="none"), shape,
                                 microbatches=1)
    assert full.breakdown["bwd_mult"] == 4.0
    assert none.breakdown["bwd_mult"] == 3.0
    assert full.total == pytest.approx(none.total * 4 / 3)
