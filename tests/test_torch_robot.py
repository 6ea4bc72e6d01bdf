"""Port parity: easyhec_torch.robot against easyhec_tpu.robot on CPU.

FK agrees to f32 roundoff (atol 1e-6: the same 4×4 composes, summed in
another order by torch's and XLA's matmuls); the numpy mesh utilities are
copies and must agree exactly.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import MINI_URDF
from easyhec_torch import robot as trb
from easyhec_torch.robot import mesh as tmesh
from easyhec_tpu import robot as jrb
from easyhec_tpu.robot import mesh as jmesh

LINKS = ["base", "upper", "fore"]


@pytest.fixture(scope="module")
def urdf_path():
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        return f.name


def test_fk_matches(urdf_path):
    jc = jrb.build_chain(jrb.parse_urdf(urdf_path))
    tc = trb.build_chain(trb.parse_urdf(urdf_path))
    assert jc.link_names == tc.link_names and jc.n_dof == tc.n_dof
    np.testing.assert_array_equal(jc.joint_limits, tc.joint_limits)
    lim = jc.joint_limits
    qs = np.random.default_rng(0).uniform(lim[:, 0], lim[:, 1], (16, jc.n_dof))
    qs = qs.astype(np.float32)
    a = np.asarray(jax.vmap(jc.fk)(jnp.asarray(qs)))
    b = tc.fk(torch.from_numpy(qs)).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6)
    # unbatched call keeps the JAX signature [n_dof] -> [n_links, 4, 4]
    np.testing.assert_allclose(
        np.asarray(jc.fk(jnp.asarray(qs[0]))), tc.fk(torch.from_numpy(qs[0])).numpy(),
        atol=1e-6,
    )


def _meshes(mod, path):
    model = mod.parse_urdf(path)
    m = mod.load_link_meshes(model, link_names=LINKS)
    return [m[n] for n in LINKS]


def _assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def test_pack_meshes_identical(urdf_path):
    pj = jmesh.pack_meshes(_meshes(jrb, urdf_path))
    pt = tmesh.pack_meshes(_meshes(trb, urdf_path))
    for f in ("vertices", "faces", "face_mesh_id", "vert_mesh_id"):
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
    assert pj.n_meshes == pt.n_meshes


@pytest.mark.parametrize("edge", [0.05, 0.02])
def test_subdivide_identical(urdf_path, edge):
    for a, b in zip(_meshes(jrb, urdf_path), _meshes(trb, urdf_path)):
        _assert_mesh_equal(jmesh.subdivide_to_max_edge(a, edge),
                           tmesh.subdivide_to_max_edge(b, edge))


def test_decimate_identical(urdf_path):
    for a, b in zip(_meshes(jrb, urdf_path), _meshes(trb, urdf_path)):
        a, b = (m.subdivide_to_max_edge(x, 0.02) for m, x in ((jmesh, a), (tmesh, b)))
        _assert_mesh_equal(jmesh.decimate_vertex_clustering(a, 0.01),
                           tmesh.decimate_vertex_clustering(b, 0.01))
