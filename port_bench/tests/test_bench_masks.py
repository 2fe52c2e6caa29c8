"""The serving judge's hold on the found set and the masks, on a made-up
frame of one class: a serpentine of 8-pixel cells that the configuration's
three sweeps leave split in two."""
import pytest
import torch

from reference import serve as RS

CFG = {"num_objects": 1, "cca_scale": 8, "crop": 32, "num_points": 16}
TIE = 0.1
H = W = 64


def _cells(rows_cols):
    small = torch.zeros(H // 8, W // 8, dtype=torch.bool)
    for r, c in rows_cols:
        small[r, c] = True
    return small.repeat_interleave(8, 0).repeat_interleave(8, 1)


# rows 0, 2, 4, 6 of cells, joined at the right, left, right ends
SERPENT = _cells([(r, c) for r in (0, 2, 4, 6) for c in range(8)]
                 + [(1, 7), (3, 0), (5, 7)])
# what three sweeps label apart from the rest: row 6 but its last cell
TAIL = _cells([(6, c) for c in range(7)])


def _frame():
    g = torch.Generator().manual_seed(0)
    return RS.Frame(image=torch.zeros(H, W, 3, dtype=torch.uint8),
                    depth=torch.full((H, W), 1000.0),
                    intr=torch.tensor([60.0, 60.0, 32.0, 32.0]),
                    depth_scale=torch.tensor(0.001),
                    uniforms=torch.rand(1, 16, generator=g))


def _logits(cls):
    """Background 0; the class 2 on `cls`, -2 elsewhere."""
    return torch.stack([torch.zeros(H, W),
                        torch.where(cls, 2.0, -2.0)])


def test_three_sweeps_split_the_serpentine():
    score = torch.ones(1, H, W)
    comp, found, converged = RS.components(SERPENT[None], score, 8, 3)
    assert bool(found[0]) and not bool(converged[0])
    assert torch.equal(comp[0], SERPENT & ~TAIL)
    comp, found, converged = RS.components(SERPENT[None], score, 8, 0)
    assert bool(converged) and torch.equal(comp[0], SERPENT)


def _gaps(served, converged):
    gaps, _ = RS.mask_gaps(_frame(), _logits(SERPENT), served[None],
                           torch.tensor([converged]), CFG, TIE)
    return gaps


@pytest.mark.parametrize("converged", [False, True])
def test_the_whole_component_is_held(converged):
    assert _gaps(SERPENT, converged) == {"mass_gap": 0.0, "cell_gap": 0.0}


def test_a_part_is_held_to_the_least_only_where_labels_converged():
    """The part that three sweeps label best is sound where the program
    says its labels did not converge, and short where it says they did."""
    part = SERPENT & ~TAIL
    assert _gaps(part, False) == {"mass_gap": 0.0, "cell_gap": 0.0}
    got = _gaps(part, True)
    assert got["mass_gap"] == pytest.approx(7 / 35, rel=1e-3)
    assert got["cell_gap"] == 0.0


@pytest.mark.parametrize("converged", [False, True])
def test_a_mask_cut_inside_its_cells(converged):
    cut = SERPENT.clone()
    cut[52:, :] = False        # half of each cell of row 6
    got = _gaps(cut, converged)
    # the mask's 35 cells hold 35 * 64 pixels of the class; half of each
    # of row 6's 8 cells is left out
    assert got["cell_gap"] == pytest.approx(8 * 32 / (35 * 64))


@pytest.mark.parametrize("converged", [False, True])
def test_a_class_left_out_or_grown(converged):
    assert _gaps(torch.zeros(H, W, dtype=torch.bool),
                 converged)["mass_gap"] == 1.0
    grown = SERPENT | _cells([(7, 0)])
    assert _gaps(grown, converged)["mass_gap"] > 0.0
