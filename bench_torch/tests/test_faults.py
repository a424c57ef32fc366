"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: ``correct`` comes out false for each fault
a serving cell can have, and true without one."""
import pytest

from efficientq_tpu_torch.eval import sliding, validate

from . import tiny
from .test_harness import run_line

CELLS = ["lits_w4a4.serve_varied_depth", "lits_w4a4.serve_fixed_depth"]


def half_of_each_chunk_left_out(monkeypatch):
    """Each chunk forward's second half of patches gives no logits."""
    make = sliding._patch_forward

    def broken_forward(*args, **kwargs):
        forward = make(*args, **kwargs)

        def broken(variables, xb):
            out = forward(variables, xb)  # (heads, N, ...)
            out[:, out.shape[1] // 2:] = 0
            return out

        return broken

    monkeypatch.setattr(sliding, "_patch_forward", broken_forward)


def answer_altered(monkeypatch):
    """Each volume's prediction altered in one corner block, where the
    inferencer produces it."""
    build = validate._build_infer

    def build_broken(*args, **kwargs):
        infer = build(*args, **kwargs)

        def broken(*a, **kw):
            pred = infer(*a, **kw).clone()  # (heads, N, D, H, W)
            d, h, w = pred.shape[2:5]
            block = pred[:, :, :d // 2, :h // 2, :w // 2]
            block.copy_((block + 1) % 3)
            return pred

        return broken

    monkeypatch.setattr(validate, "_build_infer", build_broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    root, bench = tiny.make(tmp_path)
    line = run_line(root, bench, cell)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", [half_of_each_chunk_left_out,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_serving_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root, bench = tiny.make(tmp_path)
    fault(monkeypatch)
    line = run_line(root, bench, cell)
    assert line["correct"] is False, line["checks"]
