"""A run whose timed path is broken underneath comes out not correct: the
harness is driven on the CPU at a tiny size (the look for a card skipped),
with one fault planted in the program's path at a time."""
import pytest
import torch

from perfbench.core import program
from perfbench.tests.tiny import make_tree, run_cell


@pytest.fixture
def root(tmp_path):
    return make_tree(tmp_path)


def test_sound_runs_are_correct(root, capsys):
    assert run_cell(root, "tg.register", capsys)["correct"] is True
    assert run_cell(root, "tg.train", capsys)["correct"] is True


def test_an_altered_transform_is_caught(root, capsys, monkeypatch):
    real = program.register

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        t = res["transform"].clone()
        t[0, 3] += 1e-3  # a millimetre off where the answer is produced
        res["transform"] = t
        return res

    monkeypatch.setattr(program, "register", altered)
    result = run_cell(root, "tg.register", capsys)
    assert result["correct"] is False
    assert result["checks"]["trans_gap_m"]["value"] > result["checks"]["trans_gap_m"]["limit"]


def test_altered_descriptors_are_caught(root, capsys, monkeypatch):
    real = program.register

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        f = res["outputs"]["feats_f"]
        res["outputs"]["feats_f"] = torch.nn.functional.normalize(f + 1e-2 * f.roll(1, -1), dim=-1)
        return res

    monkeypatch.setattr(program, "register", altered)
    result = run_cell(root, "tc.register", capsys)
    assert result["correct"] is False
    assert result["checks"]["feats_gap"]["value"] > result["checks"]["feats_gap"]["limit"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(root, capsys, monkeypatch):
    def unchanged(state, cfg, batch, uniforms, images):
        state.step += 1
        with torch.no_grad():
            from pcrcg_tpu_torch.train.step import eval_step

            return eval_step(state, cfg, batch, uniforms=uniforms, images=images)

    monkeypatch.setattr(program, "train_step", unchanged)
    result = run_cell(root, "tg.train", capsys)
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_an_altered_loss_is_caught(root, capsys, monkeypatch):
    real = program.train_step

    def altered(*args, **kwargs):
        stats = real(*args, **kwargs)
        stats["total"] = stats["total"] * 1.05
        return stats

    monkeypatch.setattr(program, "train_step", altered)
    result = run_cell(root, "tg.train", capsys)
    assert result["correct"] is False
    assert result["checks"]["first_loss_gap"]["value"] > result["checks"]["first_loss_gap"]["limit"]
