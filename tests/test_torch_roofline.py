"""``repro_torch.roofline``: the H100's data-sheet figures, the model's
useful FLOPs against the reference's ``model_flops`` (exactly: the same
arithmetic on configs that match field for field), and the three-term
roofline reading the collective counts of ``parallel/collectives``.  The
counts against real collectives over gloo are checked in
``tests/test_torch_ep.py``'s four-rank run."""

import pytest

from repro_torch import roofline
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.parallel import collectives
from repro_torch.roofline.hw import H100


def test_h100_holds_the_data_sheet_figures():
    """NVIDIA's H100 SXM5 80 GB data sheet, dense rates: 989 TFLOP/s bf16,
    495 TF32 (an fp32 product in 3xTF32 at a third of it), 67 fp32 off the
    tensor cores, 1,979 TOP/s int8, 3.35 TB/s and 80 GB of HBM, NVLink
    900 GB/s both directions together."""
    assert H100.peak_flops == 989e12 == H100.peak("bf16")
    assert H100.peak("tf32") == 495e12
    assert H100.peak("tf32x3") == 495e12 / 3
    assert H100.peak("fp32") == 67e12
    assert H100.peak("int8") == 1979e12
    assert H100.hbm_bw == 3.35e12
    assert H100.hbm_bytes == 80e9
    assert H100.ici_bw == 900e9
    with pytest.raises(KeyError, match="no peak"):
        H100.peak("fp64")
    # The reference's field names, so code written against one reads both.
    from repro.roofline.hw import V5E
    assert set(V5E.__dataclass_fields__) <= set(H100.__dataclass_fields__)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_matches_reference(arch):
    """Every registered arch x every shape the reference supports for it,
    train (backward) and inference: the port's ``model_flops`` equals the
    reference's exactly (integral values in float64, the same order of
    operations)."""
    from repro.configs import get_config as ref_config
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.launch.specs import supported_shapes
    from repro.roofline import model_flops as ref_model_flops

    ref_cfg = ref_config(arch)
    shapes = supported_shapes(ref_cfg)
    assert shapes
    for shape in shapes:
        for backward in (True, False):
            got = roofline.model_flops(get_config(arch), SHAPES[shape],
                                       backward=backward)
            want = ref_model_flops(ref_cfg, REF_SHAPES[shape],
                                   backward=backward)
            assert got == want and got == int(got) > 0, (shape, backward)


def test_roofline_terms_read_the_collective_counts():
    """The compute term at the dtype's peak, memory at HBM, the collective
    term at NVLink from given bytes or, without them, this process's
    counts (0 after a reset: the counting itself is checked over gloo);
    the largest term names the bottleneck."""
    t = roofline.roofline_terms(989e12, 3.35e12, 900e9)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)
    t = roofline.roofline_terms(495e12, 0.0, 0.0, dtype="tf32x3")
    assert t.compute_s == 3.0 and t.bottleneck == "compute"
    t = roofline.roofline_terms(0.0, 0.0, 2700e9)
    assert t.collective_s == 3.0 and t.bottleneck == "collective"
    table = {"all_to_all": {"bytes": 1800, "calls": 2},
             "all_gather": {"bytes": 900, "calls": 1}}
    assert roofline.collective_bytes(table) == 2700
    collectives.reset_counts()
    assert collectives.counts() == {k: {"bytes": 0, "calls": 0}
                                    for k in collectives.KINDS}
    t = roofline.roofline_terms(1.0, 1.0)
    assert t.collective_bytes_per_device == 0.0
    assert t.collectives_by_kind == collectives.counts()
    assert t.as_dict()["bottleneck"] == "memory"
