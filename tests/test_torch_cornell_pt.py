"""The port's Cornell path-tracing entry point
(`python -m software_rasterizer_tpu_torch.examples.cornell_pt`), called in
process on the CPU at 16x16: single shot, progressive batches with a
checkpoint that a second run resumes, and tile jobs. Each writes a PNG
with a finite, nonzero mean."""

import numpy as np
import pytest

from software_rasterizer_tpu_torch.examples import cornell_pt
from software_rasterizer_tpu_torch.utils.image_io import read_png

ARGS = ["--cpu", "--width", "16", "--height", "16"]


def _run(tmp_path, name, *extra, spp=1):
    out = tmp_path / f"{name}.png"
    frame = cornell_pt.main([*ARGS, "--spp", str(spp), "--out", str(out), *extra])
    png = read_png(str(out)).astype(np.float64)
    assert frame.shape == (16, 16, 3) and png.shape == (16, 16, 3)
    assert np.isfinite(frame).all() and np.isfinite(png).all()
    assert frame.mean() > 0 and png.mean() > 0
    return frame


@pytest.mark.parametrize("mode", [(), ("--tiles", "4")])
def test_single_shot_and_tiles(tmp_path, capsys, mode):
    _run(tmp_path, "cornell", *mode)
    out = capsys.readouterr().out
    assert "16x16 @ 1 spp on cpu" in out
    if mode:
        assert "tile 4/4" in out


def test_batches_resume_from_the_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "cornell_ckpt.npz")
    _run(tmp_path, "batch", "--batch", "1", "--ckpt", ckpt)
    assert int(np.load(ckpt)["n_samples"]) == 1
    capsys.readouterr()
    _run(tmp_path, "resumed", "--batch", "1", "--ckpt", ckpt, spp=2)
    out = capsys.readouterr().out
    assert "resumed at 1 spp" in out and "2/2 spp" in out
    assert int(np.load(ckpt)["n_samples"]) == 2


def test_the_card_is_the_default(tmp_path):
    """Without --cpu the run asks for the card, and raises where there is
    none rather than rendering on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would render on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cornell_pt.main(["--width", "16", "--height", "16", "--spp", "1",
                         "--out", str(tmp_path / "x.png")])
