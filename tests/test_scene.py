"""Scene construction tests (src/core/scene.rs parity)."""

import numpy as np

import ray_tracer as rt


def test_builtin_scene_counts():
    s, _ = rt.builtin_scene("balls")
    assert s.num_spheres == 6 and s.num_tris == 0
    s, _ = rt.builtin_scene("metal")
    assert s.num_spheres == 4 and s.num_tris == 0
    s, _ = rt.builtin_scene("room")
    assert s.num_spheres == 2 and s.num_tris == 14
    s, _ = rt.builtin_scene("random_balls", seed=3)
    # ground + up-to-484 grid spheres + 3 feature spheres
    assert 300 < s.num_spheres < 489 and s.num_tris == 0


def test_scene_ids_match_reference_switcher():
    # src/core/context.rs:261-279
    assert rt.SCENE_IDS == {0: "balls", 1: "random_balls", 2: "room", 3: "metal"}
    s_by_id, _ = rt.builtin_scene(3)
    s_by_name, _ = rt.builtin_scene("metal")
    assert s_by_id.num_spheres == s_by_name.num_spheres


def test_padding_and_masks():
    s, _ = rt.builtin_scene("metal", pad=128)
    assert s.padded_spheres == 128
    v = np.asarray(s.sphere_valid)
    assert v[:4].sum() == 4 and v[4:].sum() == 0


def test_smoothness_clamp_and_dielectric_passthrough():
    b = rt.SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, (1, 1, 1), smoothness=5.0)   # clamps to 1
    b.add_sphere((0, 0, 0), 1.0, (1, 1, 1), smoothness=-1.0)  # dielectric kept
    s = b.build()
    sm = np.asarray(s.sphere_smoothness)
    assert sm[0] == 1.0 and sm[1] == -1.0


def test_mesh_translation_baked():
    verts = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
    s = (rt.SceneBuilder()
         .add_mesh(verts, np.ones((3, 3)), [0, 1, 2], pos=(10, 20, 30))
         .build())
    np.testing.assert_allclose(np.asarray(s.tri_v0[0]), [10, 20, 30], atol=1e-6)
    np.testing.assert_allclose(np.asarray(s.tri_v1[0]), [11, 20, 30], atol=1e-6)


def test_room_light_mesh_offset():
    """The emissive ceiling quad sits at pos (3, 1.9, 0) (scene.rs:286-293):
    light triangle vertices must be near y = 1 + 1.9. (Triangles are
    Morton-reordered at build, so select the light by emission strength.)"""
    s, _ = rt.builtin_scene("room")
    es = np.asarray(s.tri_emission_strength)
    light = np.where(es == 10.5)[0]
    assert len(light) == 2
    v0 = np.asarray(s.tri_v0)[light]
    np.testing.assert_allclose(v0[:, 1], 2.9, atol=1e-5)
    others = np.asarray(s.tri_valid) > 0.5
    others[light] = False
    assert es[others].max() == 0.0


def test_random_balls_seeded_reproducible():
    a, _ = rt.builtin_scene("random_balls", seed=7)
    b, _ = rt.builtin_scene("random_balls", seed=7)
    np.testing.assert_array_equal(np.asarray(a.sphere_center),
                                  np.asarray(b.sphere_center))
    c, _ = rt.builtin_scene("random_balls", seed=8)
    assert not np.array_equal(np.asarray(a.sphere_center),
                              np.asarray(c.sphere_center))


def test_scene_is_pytree():
    import jax
    s, _ = rt.builtin_scene("metal")
    leaves = jax.tree_util.tree_leaves(s)
    assert len(leaves) == 26  # all array fields, counts are static metadata
    s2 = jax.tree_util.tree_map(lambda x: x * 1.0, s)
    assert s2.num_spheres == s.num_spheres
