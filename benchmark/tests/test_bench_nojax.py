"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level module name; the reference imports nothing of the
program; without a card the run exits without a result."""

import ast
import os
import subprocess
import sys

from harness import discover, guard


def test_no_source_under_benchmark_imports_jax():
    assert guard.forbidden_imports(discover.BENCH_DIR) == []


def test_top_level_names_compared_whole():
    assert guard.forbidden_loaded(["software_rasterizer_tpu_torch",
                                   "software_rasterizer_tpu_torch.ops.path",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["software_rasterizer_tpu.ops", "jax.numpy", "jaxlib",
                                   "flax.linen", "torch"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "software_rasterizer_tpu.ops"]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "numpy", "torch", "types", "reference"}
    for path in sorted((discover.BENCH_DIR / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert guard.top(n) in allowed, f"{path}: imports {n}"


def test_a_cell_run_loads_no_jax():
    # a whole run on the CPU at a tiny size, in a fresh process
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(discover.BENCH_DIR)!r}, {str(discover.ROOT)!r}]\n"
        "from harness import cell, discover, guard\n"
        "b = discover.load_benchmark()\n"
        "cfg = discover.cell(b, 'cornell_box.path16')['config']\n"
        "r = cell.run_cell(b, 'cornell_box.path16', 7, 0.2, False, time.perf_counter(),\n"
        "                  device='cpu', overrides={'width': 16, 'height': 16,\n"
        "                                           'path': dict(cfg['path'], spp=2)})\n"
        "assert r['correct'], r\n"
        "print('LOADED', guard.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(discover.BENCH_DIR / "run.py"), "--workload",
         "cornell_box.path16", "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=discover.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
