"""Built-in benchmark/demo scenes (the reference hardcodes its scenes in
src/main.cpp and the README walkthroughs; here they are library code)."""

from software_rasterizer_tpu_torch.scenes.cornell import build_cornell_scene

__all__ = ["build_cornell_scene"]
