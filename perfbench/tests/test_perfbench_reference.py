"""The frozen reference agrees with the port at a tiny size on the CPU
(this test imports the port; the reference imports nothing of it)."""
import torch

from perfbench.core import files, harness, weights
from perfbench.core import program
from perfbench.reference import pipeline
from perfbench.tests.tiny import make_tree, run_cell


def test_registration_agrees_with_the_reference(tmp_path, capsys):
    root = make_tree(tmp_path)
    for cell in ("tc.register", "tg.register"):
        result = run_cell(root, cell, capsys)
        checks = result["checks"]
        assert result["correct"] is True, checks
        assert checks["pyramid_mismatch"]["value"] == 0.0
        assert checks["feats_gap"]["value"] < 1e-4
        assert checks["rot_gap"]["value"] == 0.0


def test_first_training_gradient_agrees_with_the_reference(tmp_path):
    torch.set_num_threads(2)
    root = make_tree(tmp_path)
    cell = files.load_cell("tg.train", root)
    dev = torch.device("cpu")
    cfg = program.port_config(cell["sections"])
    shapes = program.model_shapes(cfg)
    state = weights.seeded_state(shapes, 3, dev)
    pool = files.make_pool(cell["traffic_params"], 4, dev, images=False)
    draws = program.draws(cfg, pool[0], torch.Generator().manual_seed(5), dev, True)
    model = program.build_model(cfg, state, dev)
    ts = program.train_state(cfg, model, 1000)
    names = {id(p): weights.canonical(n, False) for n, p in model.named_parameters()}
    grads = {}
    for p in ts.params:
        p.register_hook(lambda g, n=names[id(p)]: grads.__setitem__(n, g.clone()))
    stats = program.train_step(ts, cfg, program.make_batch(pool[0], cfg, dev),
                               draws["uniforms"], None)
    rcfg = pipeline.config_from_sections(cell["sections"])
    ref = pipeline.build_model(rcfg, state, dev)
    leaves = [p for p in ref.parameters() if p.requires_grad]
    rnames = [n for n, p in ref.named_parameters() if p.requires_grad]
    ref_stats, ref_grads = pipeline.train_step(
        ref, leaves, torch.optim.SGD(leaves, lr=0.0), rcfg, pipeline.pair_batch(pool[0], rcfg, dev),
        draws["uniforms"])
    assert abs(float(stats["total"]) - float(ref_stats["total"])) < 1e-5 * float(ref_stats["total"])
    norms = sorted(float(g.norm()) for g in ref_grads)
    median = norms[len(norms) // 2]
    for n, g in zip(rnames, ref_grads):
        gap = float((grads[n] - g).norm()) / max(float(g.norm()), median)
        assert gap < 1e-3, n


def test_same_seed_same_weights_on_both_sides():
    dev = torch.device("cpu")
    from perfbench.tests.tiny import GEOMETRY

    cfg = program.port_config(GEOMETRY)
    shapes = program.model_shapes(cfg)
    a = weights.seeded_state(shapes, harness.sub_seed(2**31 + 9, 0), dev)
    b = weights.seeded_state(shapes, harness.sub_seed(2**31 + 9, 0), dev)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ref = pipeline.build_model(pipeline.config_from_sections(GEOMETRY), a, dev)
    port = program.build_model(cfg, a, dev)
    for n, t in port.state_dict().items():
        assert torch.equal(t, ref.state_dict()[weights.canonical(n, False)]), n
