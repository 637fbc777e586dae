"""Nothing the harness runs loads JAX or the JAX package (compared by whole
top-level module name: ``pcrcg_tpu_torch`` begins with ``pcrcg_tpu``), and
the reference loads nothing of the port either."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", f"import sys; {code}; print({TOP})"],
                         cwd=REPO, capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    top = _top_level("import perfbench.reference.pipeline, perfbench.reference.models.pcrcg")
    assert not top & {"jax", "jaxlib", "flax", "pcrcg_tpu", "pcrcg_tpu_torch"}


def test_a_harness_run_loads_no_jax(tmp_path):
    code = (
        "sys.path.insert(0, '.');"
        "from pathlib import Path;"
        "from perfbench.tests.tiny import make_tree;"
        "from perfbench.core.harness import run, forbidden_modules;"
        f"root = make_tree(Path({str(tmp_path)!r}));"
        "import torch; torch.set_num_threads(2);"
        "assert run(['--workload', 'tg.register', '--seed', '3', '--seconds', '0.3',"
        " '--trace', '0'], root=root, repo_root=root, device='cpu') == 0;"
        "assert forbidden_modules() == []"
    )
    top = _top_level(code)
    assert "pcrcg_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pcrcg_tpu"}


def test_forbidden_names_are_whole_top_level_names():
    from perfbench.core.harness import forbidden_modules

    assert forbidden_modules(["pcrcg_tpu_torch", "pcrcg_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["pcrcg_tpu.models", "jax._src.core", "flax"]) == [
        "flax", "jax", "pcrcg_tpu"]
