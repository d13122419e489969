"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test decides inside itself (through the `cuda` fixture)
whether a card is present and skips with a reason where there is none.
Run them on a machine with a card with `python -m pytest
tests/test_torch_gpu.py -n 0`.  K1 must be bit-exact; K2 within 5e-3 on
every value and 1e-4 on >= 99.9 % of them (a sequential walk and the
vectorised plain version may flip one blend at a threshold); the whole
render on the card within atol 2e-5 / rtol 1e-4 of the CPU render.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_expand_kernel_bit_exact(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import binning

    for _, mark_pos, rank1, rect, budget in cs.expand_cases():
        c = binning.compact_marks(
            *(torch.as_tensor(a, device=cuda) for a in (mark_pos, rank1,
                                                        rect)), budget)
        before = binning.EXPAND.launches
        got = binning.expand_marks(*c, budget)
        assert binning.EXPAND.launches == before + 1
        want = binning.expand_marks_plain(*c, budget)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_tile_fwd_kernel_matches_plain(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.ops import tile_render

    _, _, k2in = cs.kernel_inputs(cuda, 200, 136, 20000, (0.01, 0.05), 1 << 17)
    before = tile_render.TILE_FWD.launches
    got = tile_render.tile_fwd(*k2in, 13, 200, 136)
    assert tile_render.TILE_FWD.launches == before + 1
    want = tile_render.tile_fwd_plain(*k2in, 13, 200, 136)
    torch.cuda.synchronize()
    err, share = cs.compare_k2(got, want)
    assert err <= 5e-3 and share >= 0.999, (err, share)
    # empty tiles and rows 4..7
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))


def test_render_on_card_matches_cpu(cuda):
    import chip_smoke as cs
    from reduced3dgs_torch.cameras import Camera
    from reduced3dgs_torch.renderer import render

    arrs = cs.bench_scene(3000, (0.02, 0.08), 2)
    cam = Camera.look_at(eye=(0.5, 0.2, -3.4), target=(0, 0, 0), width=120,
                         height=72)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        a = [torch.as_tensor(x, device=dev) for x in arrs]
        outs.append(render(*a, cam.params(dev),
                           torch.tensor([0.1, 0.2, 0.3], device=dev),
                           width=120, height=72, instance_budget=1 << 15))
    cpu, gpu = outs
    np.testing.assert_allclose(gpu.color.cpu().numpy(), cpu.color.numpy(),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(gpu.final_t.cpu().numpy(),
                               cpu.final_t.numpy(), atol=2e-5, rtol=1e-4)
