"""The benchmark's plain reference: the renderer's semantics written out
again in plain PyTorch, frozen in this folder.

It imports torch and numpy only, nothing of the program under test, and
reads only the scene inputs the benchmark made (`harness.inputs`): mesh
vertices, faces, materials, lights and matrices. Every table it traces
against (trace-space triangles, emitter spheres, raster coefficients) it
works out again itself. Each renderer takes a float `dtype`: float32 is
the reference, a lower precision is the control (`benchmark/control.py`).
"""
