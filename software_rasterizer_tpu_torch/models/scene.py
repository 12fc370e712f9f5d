"""Scene assembly + flattening to host arrays (the JAX package's
models/scene.py, unchanged in behaviour: its tables are the port's
inputs, and tests/test_torch_scene.py holds them equal).

Mirrors the reference Scene's assembly API (Scene.hpp:46-84:
addGraphicObj / startLoadingMesh / getMeshObj / addShader /
bindShader2Mesh / addLight / setModelMatrix / setViewMatrix /
setProjectionMatrix / setNDCMatrix) but deliberately does NOT carry the
integrators — those are pure functions in ops/ consuming the flattened
arrays (SURVEY.md "Key architectural fact").

Flattening produces two kinds of bundles:

  * geometry bundles — static SoA arrays (verts, faces, materials,
    textures), uploaded once per scene;
  * frame bundles — per-frame matrices and light tables (tiny), so an
    animation re-runs only the device step.

Objects iterate in name-sorted order, reproducing the reference's
std::map iteration (Scene.hpp m_loadedObjs) which fixes tie-breaking and
light-sampling indices.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from software_rasterizer_tpu_torch.models.lights import PointLight, pack_lights
from software_rasterizer_tpu_torch.models.material import MaterialTable
from software_rasterizer_tpu_torch.models.objects import (
    MeshObject,
    SceneObject,
    ShaderBinding,
    SphereLight,
    SphereObject,
)
from software_rasterizer_tpu_torch.utils import transforms as tf
from software_rasterizer_tpu_torch.utils.log import logger
from software_rasterizer_tpu_torch.utils.obj_loader import load_obj
from software_rasterizer_tpu_torch.utils.profiling import span
from software_rasterizer_tpu_torch.utils.texture import Texture


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class RasterGeometry(NamedTuple):
    """Static raster-side scene arrays (host numpy; ops move to device)."""

    positions: np.ndarray   # (V,3) f32 untransformed
    normals: np.ndarray     # (V,3) f32
    uvs: np.ndarray         # (V,2) f32
    colors: np.ndarray      # (V,3) f32
    vertex_mesh: np.ndarray  # (V,) i32
    faces: np.ndarray       # (F,3) i32 (global vertex ids, padded w/ 0)
    face_mesh: np.ndarray   # (F,) i32
    face_valid: np.ndarray  # (F,) bool
    shader_type: np.ndarray  # (M,) i32 per mesh
    tex_id: np.ndarray      # (M,) i32 per mesh (-1 = none)
    textures: np.ndarray    # (K,Hm,Wm,3) u8 atlas (K >= 1)
    tex_wh: np.ndarray      # (K,2) i32 (width, height)


class RasterFrame(NamedTuple):
    """Per-frame raster inputs (Scene::loadTriangleStream equivalents)."""

    ndc_mvp: np.ndarray     # (M,4,4)
    normal_mat: np.ndarray  # (M,4,4) transpose(inverse(model))
    z_scale: np.ndarray     # () f32
    z_offset: np.ndarray    # () f32
    eye: np.ndarray         # (3,)
    light_pos: np.ndarray   # (L,3)
    light_int: np.ndarray   # (L,3)


class RTGeometry(NamedTuple):
    """Static ray-tracing-side scene arrays."""

    positions: np.ndarray    # (V,3)
    normals: np.ndarray      # (V,3)
    uvs: np.ndarray          # (V,2)
    vertex_mesh: np.ndarray  # (V,) i32
    faces: np.ndarray        # (F,3)
    face_mesh: np.ndarray    # (F,) i32
    face_valid: np.ndarray   # (F,) bool
    tri_mat: np.ndarray      # (F,) i32 material id
    tri_tex: np.ndarray      # (F,) i32 texture id (-1 none)
    tri_obj: np.ndarray      # (F,) i32 top-level object id
    sph_center: np.ndarray   # (S,3) untransformed
    sph_radius: np.ndarray   # (S,)
    sph_model: np.ndarray    # (S,4,4)
    sph_mat: np.ndarray      # (S,) i32
    sph_obj: np.ndarray      # (S,) i32
    sph_valid: np.ndarray    # (S,) bool
    obj_emissive: np.ndarray  # (O,) bool per top-level object
    materials: MaterialTable
    textures: np.ndarray     # (K,Hm,Wm,3)
    tex_wh: np.ndarray       # (K,2)
    # shape-encoded flag ((1,) if any EMISSIVE triangle carries a
    # texture, else (0,)), kept in the JAX package's encoding. Texture
    # color feeds path tracing ONLY at emissive hits (Scene.cpp:676-680;
    # the BRDF eval reads material Kd, Material.cpp:60), so this is the
    # exact criterion for the camera kernel's color-is-Kd shading.
    tex_on_emitter: np.ndarray = np.zeros(0, bool)
    # (K,Hm,Wm) i32 r|g<<8|b<<16 packed atlas (texture_ops.pack_atlas):
    # one word per texel for the device fetch
    tex_packed: np.ndarray = np.zeros((1, 1, 1), np.int32)


class RTFrame(NamedTuple):
    """Per-frame RT inputs (Scene::updatePosition equivalents)."""

    mvp: np.ndarray          # (M,4,4) P*V*M per mesh
    normal_mat3: np.ndarray  # (M,3,3)
    sph_mvp: np.ndarray      # (S,4,4) P*V*M per sphere
    sph_scale: np.ndarray    # (S,) max model-scale component
    eye: np.ndarray          # (3,)
    background: np.ndarray   # (3,)


class Scene:
    """Host-side scene assembly, API-compatible with the reference."""

    def __init__(
        self,
        name: str,
        eye=(0.0, 0.0, -0.9),
        center=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        background=(0.0, 0.0, 0.0),
        max_depth: int = 5,
        rr: float = 0.8,
    ):
        self.name = name
        self.background = np.asarray(background, np.float32)
        self.max_depth = max_depth
        self.rr = rr
        self.fovy = 45.0  # Scene.cpp:26
        self.near, self.far = 0.1, 100.0
        self.width = self.height = 0
        self._objects: Dict[str, SceneObject] = {}
        self._pending: Dict[str, tuple] = {}  # name -> (path, model kwargs)
        self._shaders: Dict[str, ShaderBinding] = {}
        self._lights: Dict[str, PointLight] = {}
        self.set_view_matrix(eye, center, up)
        self.projection = np.eye(4, dtype=np.float32)
        self.ndc = np.eye(4, dtype=np.float32)

    # -- assembly API (Scene.cpp:38-244) ------------------------------------

    def add_graphic_obj(
        self,
        obj_or_path: Union[str, SceneObject],
        name: str,
        axis=(0.0, 1.0, 0.0),
        angle: float = 0.0,
        translation=(0.0, 0.0, 0.0),
        scale=(1.0, 1.0, 1.0),
    ) -> bool:
        if name in self._objects or name in self._pending:
            logger.error("Object %s already identified", name)
            return False
        if isinstance(obj_or_path, str):
            self._pending[name] = (obj_or_path, axis, angle, translation, scale)
        else:
            self._objects[name] = obj_or_path
        return True

    def start_loading_mesh(self, name: str) -> bool:
        if name not in self._pending:
            logger.error("Nothing pending for %s", name)
            return False
        path, axis, angle, translation, scale = self._pending.pop(name)
        data = load_obj(path, name)
        obj = MeshObject(data)
        obj.update_model_matrix(axis, angle, translation, scale)
        self._objects[name] = obj
        return True

    def get_mesh_obj(self, name: str) -> Optional[SceneObject]:
        return self._objects.get(name)

    def add_shader(self, shader_name: str, texture, shader_type: int) -> bool:
        if shader_name in self._shaders:
            logger.error("Shader %s already exists", shader_name)
            return False
        tex = Texture.load(texture) if isinstance(texture, str) else texture
        self._shaders[shader_name] = ShaderBinding(shader_name, int(shader_type), tex)
        return True

    def bind_shader_to_mesh(self, mesh_name: str, shader_name: str) -> bool:
        if mesh_name not in self._objects or shader_name not in self._shaders:
            logger.error("bind_shader_to_mesh: unknown %s/%s", mesh_name, shader_name)
            return False
        self._objects[mesh_name].bind_shader(self._shaders[shader_name])
        return True

    def add_light(self, name: str, light: PointLight):
        if name in self._lights:
            logger.warning("Light %s already added", name)
            return
        self._lights[name] = light

    def add_lights(self, lights: List[Tuple[str, PointLight]]):
        for name, l in lights:
            self.add_light(name, l)

    def camera_light(self, status_or_intensity=True):
        """Scene.cpp:233-244."""
        if status_or_intensity is False:
            inten = (0.0, 0.0, 0.0)
        elif status_or_intensity is True:
            inten = (1.0, 1.0, 1.0)
        else:
            inten = tuple(status_or_intensity)
        self._lights["sys_camera"] = PointLight(tuple(self.eye), inten)

    # -- MVP (Scene.cpp:246-335) --------------------------------------------

    def set_model_matrix(self, name: str, axis, angle: float, translation, scale) -> bool:
        if name not in self._objects:
            logger.error("set_model_matrix: %s not found", name)
            return False
        self._objects[name].update_model_matrix(axis, angle, translation, scale)
        return True

    def set_view_matrix(self, eye, center, up):
        self.eye = np.asarray(eye, np.float32)
        self.center = np.asarray(center, np.float32)
        self.up = np.asarray(up, np.float32)
        self.view = tf.look_at_lh(eye, center, up)

    def set_projection_matrix(self, fovy: float, z_near: float, z_far: float):
        """Quirk preserved: fovy forwarded raw (degrees) to the radians-
        expecting projection (Scene.cpp:293)."""
        self.fovy, self.near, self.far = fovy, z_near, z_far
        if self.height:
            aspect = self.width / float(self.height)
        else:
            aspect = 0.0  # reference leaves m_aspectRatio 0 until setNDCMatrix
        self.projection = tf.perspective_lh_no(fovy, aspect or 1.0, z_near, z_far)

    def set_ndc_matrix(self, width: int, height: int):
        self.width, self.height = width, height
        self.ndc = tf.ndc_to_screen(width, height)
        # keep projection consistent with the (possibly new) aspect
        self.projection = tf.perspective_lh_no(self.fovy, width / float(height), self.near, self.far)

    # -- flattening -----------------------------------------------------------

    def _sorted_objects(self) -> List[Tuple[str, SceneObject]]:
        return sorted(self._objects.items(), key=lambda kv: kv[0])

    def meshes(self) -> List[Tuple[str, MeshObject]]:
        return [(n, o) for n, o in self._sorted_objects() if isinstance(o, MeshObject)]

    def spheres(self) -> List[Tuple[str, SphereObject]]:
        return [(n, o) for n, o in self._sorted_objects() if isinstance(o, SphereObject)]

    def load_lights(self) -> List[PointLight]:
        """m_lights + emissive SphereLights (Scene.cpp:296-312)."""
        out = list(self._lights.values())
        for _, o in self._sorted_objects():
            if isinstance(o, SphereLight) and o.is_self_emissive():
                out.append(PointLight(tuple(o.center), tuple(o.intensity)))
        return out

    def _texture_atlas(self, bindings: List[Optional[ShaderBinding]]):
        """Stack bound textures into one padded (K,Hm,Wm,3) uint8 array.

        uint8 storage: the device fetch gathers 4x fewer bytes and
        converts u8/255 AFTER the gather — bit-identical to loading f32
        texels (the decode does the same u8 -> f32/255)."""
        texs: List[Texture] = []
        ids: Dict[int, int] = {}
        for b in bindings:
            if b is not None and b.texture is not None and id(b.texture) not in ids:
                ids[id(b.texture)] = len(texs)
                texs.append(b.texture)
        if not texs:
            atlas = np.zeros((1, 1, 1, 3), np.uint8)
            wh = np.array([[1, 1]], np.int32)
            return atlas, wh, ids
        hm = max(t.height for t in texs)
        # wm >= 2 keeps a REAL atlas distinguishable from the no-texture
        # (1,1,1,3) dummy (the JAX package dispatches on atlas size).
        # tex_wh still records true extents, so fetches clamp to the real
        # texels and never read the pad column.
        wm = max(max(t.width for t in texs), 2)
        atlas = np.zeros((len(texs), hm, wm, 3), np.uint8)
        wh = np.zeros((len(texs), 2), np.int32)
        for i, t in enumerate(texs):
            atlas[i, : t.height, : t.width] = np.round(t.data * 255.0).astype(np.uint8)
            wh[i] = (t.width, t.height)
        return atlas, wh, ids

    def raster_geometry(self, pad_faces_to: int = 128) -> RasterGeometry:
        meshes = self.meshes()
        from software_rasterizer_tpu_torch.ops.shading import ShaderType

        positions, normals, uvs, colors, vmesh = [], [], [], [], []
        faces, fmesh = [], []
        shader_type, tex_id = [], []
        bindings = [o.shader for _, o in meshes]
        atlas, wh, tex_ids = self._texture_atlas(bindings)
        v_off = 0
        for mi, (name, o) in enumerate(meshes):
            d = o.data
            positions.append(d.vertices)
            normals.append(d.normals)
            uvs.append(d.uvs)
            colors.append(d.colors)
            vmesh.append(np.full(d.vertices.shape[0], mi, np.int32))
            faces.append(d.faces.astype(np.int64) + v_off)
            fmesh.append(np.full(d.faces.shape[0], mi, np.int32))
            b = o.shader
            shader_type.append(b.type if b else int(ShaderType.PHONG))
            tex_id.append(
                tex_ids.get(id(b.texture), -1) if (b and b.texture is not None) else -1
            )
            v_off += d.vertices.shape[0]

        if not meshes:
            positions = [np.zeros((3, 3), np.float32)]
            normals = [np.zeros((3, 3), np.float32)]
            uvs = [np.zeros((3, 2), np.float32)]
            colors = [np.ones((3, 3), np.float32)]
            vmesh = [np.zeros(3, np.int32)]
            faces = [np.zeros((0, 3), np.int64)]
            fmesh = [np.zeros(0, np.int32)]
            shader_type, tex_id = [int(ShaderType.PHONG)], [-1]

        f = np.concatenate(faces).astype(np.int32).reshape(-1, 3)
        fm = np.concatenate(fmesh)
        n_faces = f.shape[0]
        n_pad = max(_round_up(max(n_faces, 1), pad_faces_to), pad_faces_to)
        valid = np.zeros(n_pad, bool)
        valid[:n_faces] = True
        f_pad = np.zeros((n_pad, 3), np.int32)
        f_pad[:n_faces] = f
        fm_pad = np.zeros(n_pad, np.int32)
        fm_pad[:n_faces] = fm

        return RasterGeometry(
            positions=np.concatenate(positions).astype(np.float32),
            normals=np.concatenate(normals).astype(np.float32),
            uvs=np.concatenate(uvs).astype(np.float32),
            colors=np.concatenate(colors).astype(np.float32),
            vertex_mesh=np.concatenate(vmesh),
            faces=f_pad,
            face_mesh=fm_pad,
            face_valid=valid,
            shader_type=np.asarray(shader_type, np.int32),
            tex_id=np.asarray(tex_id, np.int32),
            textures=atlas,
            tex_wh=wh,
        )

    def raster_frame(self) -> RasterFrame:
        meshes = self.meshes()
        n = max(len(meshes), 1)
        ndc_mvp = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        nmat = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for mi, (_, o) in enumerate(meshes):
            ndc_mvp[mi] = self.ndc @ self.projection @ self.view @ o.model
            nmat[mi] = tf.normal_matrix_mat4(o.model)
        z_scale, z_offset = tf.z_remap_params(self.near, self.far)
        lp, li = pack_lights(self.load_lights())
        return RasterFrame(
            ndc_mvp=ndc_mvp,
            normal_mat=nmat,
            z_scale=z_scale,
            z_offset=z_offset,
            eye=self.eye,
            light_pos=lp,
            light_int=li,
        )

    @span("srt.scene_geometry")
    def rt_geometry(self, pad_faces_to: int = 128, bvh_order: bool = True) -> RTGeometry:
        """Flatten to trace arrays. `bvh_order` permutes the global face
        list into BVH leaf (DFS) order so fixed-size face chunks are
        spatially tight — the top level of the vectorized two-level BVH
        (ops/bvh.py); chunk AABB culling in ops/intersect.py then skips
        whole (ray-block x chunk) tiles."""
        meshes = self.meshes()
        spheres = self.spheres()
        objs = self._sorted_objects()
        obj_index = {name: i for i, (name, _) in enumerate(objs)}

        materials = [o.material for _, o in objs]
        mat_index = {id(o.material): i for i, (_, o) in enumerate(objs)}
        table = MaterialTable.pack(materials)

        bindings = [o.shader for _, o in meshes]
        atlas, wh, tex_ids = self._texture_atlas(bindings)

        positions, normals, uvs, vmesh = [], [], [], []
        faces, fmesh, tmat, ttex, tobj = [], [], [], [], []
        v_off = 0
        for mi, (name, o) in enumerate(meshes):
            d = o.data
            positions.append(d.vertices)
            normals.append(d.normals)
            uvs.append(d.uvs)
            vmesh.append(np.full(d.vertices.shape[0], mi, np.int32))
            nf = d.faces.shape[0]
            faces.append(d.faces.astype(np.int64) + v_off)
            fmesh.append(np.full(nf, mi, np.int32))
            tmat.append(np.full(nf, mat_index[id(o.material)], np.int32))
            b = o.shader
            tid = tex_ids.get(id(b.texture), -1) if (b and b.texture is not None) else -1
            ttex.append(np.full(nf, tid, np.int32))
            tobj.append(np.full(nf, obj_index[name], np.int32))
            v_off += d.vertices.shape[0]

        if meshes:
            f = np.concatenate(faces).astype(np.int32).reshape(-1, 3)
            fm, tm, tt, to = (np.concatenate(x) for x in (fmesh, tmat, ttex, tobj))
            pos = np.concatenate(positions).astype(np.float32)
            nrm = np.concatenate(normals).astype(np.float32)
            uv = np.concatenate(uvs).astype(np.float32)
            vm = np.concatenate(vmesh)
            if bvh_order and f.shape[0] > 2:
                from software_rasterizer_tpu_torch.ops import bvh as bvh_mod

                tv = pos[f]
                lo, hi = bvh_mod.primitive_bounds(tv[:, 0], tv[:, 1], tv[:, 2])
                areas = bvh_mod.triangle_areas(tv[:, 0], tv[:, 1], tv[:, 2])
                perm = bvh_mod.leaf_order(bvh_mod.build_bvh(lo, hi, areas))
                f, fm, tm, tt, to = f[perm], fm[perm], tm[perm], tt[perm], to[perm]
        else:
            f = np.zeros((0, 3), np.int32)
            fm = tm = tt = to = np.zeros(0, np.int32)
            pos = nrm = np.zeros((3, 3), np.float32)
            uv = np.zeros((3, 2), np.float32)
            vm = np.zeros(3, np.int32)

        n_faces = f.shape[0]
        n_pad = max(_round_up(max(n_faces, 1), pad_faces_to), pad_faces_to)
        valid = np.zeros(n_pad, bool)
        valid[:n_faces] = True

        def pad2(a, fill=0):
            out = np.full((n_pad,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        # spheres (padded to >= 1)
        ns = max(len(spheres), 1)
        sc = np.zeros((ns, 3), np.float32)
        sr = np.zeros(ns, np.float32)
        smodel = np.tile(np.eye(4, dtype=np.float32), (ns, 1, 1))
        smat = np.zeros(ns, np.int32)
        sobj = np.zeros(ns, np.int32)
        svalid = np.zeros(ns, bool)
        for si, (name, o) in enumerate(spheres):
            sc[si] = o.center
            sr[si] = o.radius
            smodel[si] = o.model
            smat[si] = mat_index[id(o.material)]
            sobj[si] = obj_index[name]
            svalid[si] = True

        obj_emissive = np.array(
            [o.is_self_emissive() for _, o in objs] or [False], bool
        )
        toe = bool(np.any(
            valid & (pad2(tt, fill=-1) >= 0) & obj_emissive[pad2(to)]
        ))

        from software_rasterizer_tpu_torch.ops.texture_ops import pack_atlas

        return RTGeometry(
            tex_on_emitter=np.zeros(1 if toe else 0, bool),
            tex_packed=np.asarray(pack_atlas(atlas)),
            positions=pos,
            normals=nrm,
            uvs=uv,
            vertex_mesh=vm,
            faces=pad2(f),
            face_mesh=pad2(fm),
            face_valid=valid,
            tri_mat=pad2(tm),
            tri_tex=pad2(tt, fill=-1),
            tri_obj=pad2(to),
            sph_center=sc,
            sph_radius=sr,
            sph_model=smodel,
            sph_mat=smat,
            sph_obj=sobj,
            sph_valid=svalid,
            obj_emissive=obj_emissive,
            materials=table,
            textures=atlas,
            tex_wh=wh,
        )

    def rt_frame(self) -> RTFrame:
        meshes = self.meshes()
        spheres = self.spheres()
        nm = max(len(meshes), 1)
        mvp = np.tile(np.eye(4, dtype=np.float32), (nm, 1, 1))
        nmat3 = np.tile(np.eye(3, dtype=np.float32), (nm, 1, 1))
        for mi, (_, o) in enumerate(meshes):
            mvp[mi] = self.projection @ self.view @ o.model
            nmat3[mi] = tf.normal_matrix_mat3(o.model)
        ns = max(len(spheres), 1)
        sscale = np.ones(ns, np.float32)
        smvp = np.tile(np.eye(4, dtype=np.float32), (ns, 1, 1))
        for si, (_, o) in enumerate(spheres):
            sscale[si] = tf.decompose_max_scale(o.model)
            smvp[si] = self.projection @ self.view @ o.model
        return RTFrame(
            mvp=mvp,
            normal_mat3=nmat3,
            sph_mvp=smvp,
            sph_scale=sscale,
            eye=self.eye,
            background=self.background,
        )
