"""Next-event estimation tests: light table, estimator consistency,
variance reduction."""

import numpy as np
import jax
import jax.numpy as jnp

import ray_tracer as rt
from ray_tracer.lights import build_light_table, sample_lights
from ray_tracer.renderer import render_frame


def test_light_table_room():
    scene, _ = rt.builtin_scene("room")
    lt = build_light_table(scene)
    assert bool(lt.has_lights)
    # the two ceiling-quad triangles are the only emitters
    # packed cols: [p_light | area | emission(3) | prim_id | is_tri | ...]
    packed = np.asarray(lt.packed)
    cdf = np.asarray(lt.cdf)
    n_real = int((np.diff(np.concatenate([[0.0], cdf])) > 0).sum())
    assert n_real == 2
    assert (packed[:2, 6] == 1.0).all()  # triangles
    np.testing.assert_allclose(packed[0, 2:5], [10.5] * 3, atol=1e-5)


def test_light_table_empty_scene():
    scene, _ = rt.builtin_scene("metal")  # no emitters
    lt = build_light_table(scene)
    assert not bool(lt.has_lights)


def test_sample_lights_points_on_light():
    scene, _ = rt.builtin_scene("room")
    lt = build_light_table(scene)
    p = jnp.zeros((256, 3))
    state = jnp.arange(256, dtype=jnp.uint32)
    _, ls = sample_lights(lt, scene, state, p)
    pts = np.asarray(p + ls["wi"])
    ok = np.asarray(ls["ok"])
    # light quad: x in [2,4] (pos 3 ± 1), y = 2.9, z in [-1,1]
    assert ok.any()
    np.testing.assert_allclose(pts[ok][:, 1], 2.9, atol=1e-4)
    assert pts[ok][:, 0].min() >= 2.0 - 1e-4 and pts[ok][:, 0].max() <= 4.0 + 1e-4


def _mean_image(scene, cam, params, frames):
    basis = rt.camera_basis(cam)
    imgs = [np.asarray(render_frame(scene, basis, params, jnp.int32(i)))
            for i in range(frames)]
    return np.mean(imgs, 0), np.var(imgs, 0)


def test_nee_matches_bsdf_sampling_converged():
    """NEE must not change the converged image (same transport integral).

    Single diffuse floor + one emissive sphere, enough frames for the means
    to agree within sampling error."""
    b = rt.SceneBuilder()
    b.add_sphere((0, -100.0, 0), 99.0, (0.8, 0.8, 0.8), smoothness=0.0)
    b.add_sphere((0, 4.0, 0), 2.0, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=5.0)
    scene = b.build(pad=8)
    cam = rt.Camera(origin=(0, 2.2, 8.0), look_at=(0, 0.5, 0), fov=35.0,
                    aspect=1.0)
    base = rt.RenderParams(width=24, height=24, bounces=2, skybox=False,
                           backend="jnp")
    m_off, v_off = _mean_image(scene, cam, base, 120)
    m_on, v_on = _mean_image(scene, cam, base.replace(nee=True), 120)
    # means agree to within a few std errors, image-average level
    assert abs(m_on.mean() - m_off.mean()) < 0.015, (m_on.mean(), m_off.mean())

    # variance reduction on lit diffuse pixels (the whole point of NEE)
    lit = m_off.mean(-1) > 0.01
    assert v_on[lit].mean() < v_off[lit].mean() * 0.7


def test_nee_primary_emission_still_counted():
    """Looking straight at the light: NEE must not lose direct emission."""
    b = rt.SceneBuilder()
    b.add_sphere((0, 0, -5), 1.0, (0, 0, 0), emission=(1.0, 0.5, 0.25),
                 emission_strength=2.0)
    scene = b.build(pad=8)
    cam = rt.Camera(origin=(0, 0, 0), look_at=(0, 0, -1), fov=10.0, aspect=1.0)
    p = rt.RenderParams(width=8, height=8, bounces=2, backend="jnp", nee=True)
    img = np.asarray(rt.render(scene, cam, p))
    np.testing.assert_allclose(
        img, np.broadcast_to([2.0, 1.0, 0.5], img.shape), rtol=1e-4)


def test_nee_off_is_bitwise_reference():
    """nee=False must not perturb the original path (same RNG stream)."""
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    p0 = rt.RenderParams(width=12, height=12, bounces=2, backend="jnp")
    basis = rt.camera_basis(cam)
    a = np.asarray(render_frame(scene, basis, p0, jnp.int32(0)))
    b = np.asarray(render_frame(scene, basis, p0.replace(nee=False),
                                jnp.int32(0)))
    np.testing.assert_array_equal(a, b)


def test_cosine_sampling_renders_finite():
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    p = rt.RenderParams(width=12, height=12, bounces=2, backend="jnp",
                        cosine_sampling=True, nee=True)
    img = np.asarray(rt.render(scene, cam, p, frames=3))
    assert np.isfinite(img).all()
    assert img.max() > 0


def test_light_table_entry_valid():
    scene, _ = rt.builtin_scene("room")
    lt = build_light_table(scene)
    ev = np.asarray(lt.entry_valid)
    assert ev[:2].all() and not ev[2:].any()  # 2 real emitters (ceiling quad)


def test_overflow_emitters_still_counted(monkeypatch):
    """Emitters beyond MAX_LIGHTS are never NEE-sampled; their emission must
    still arrive via BSDF sampling (ADVICE r1: blanket suppression darkened
    scenes with more emitters than table slots). MAX_LIGHTS is shrunk to 1
    so the out-of-table light carries a large, testable share."""
    import ray_tracer.lights as lights_mod
    monkeypatch.setattr(lights_mod, "MAX_LIGHTS", 1)

    def make_scene():
        b = rt.SceneBuilder()
        # diffuse floor
        b.add_mesh(np.array([[-20, 0, -20], [20, 0, -20], [20, 0, 20],
                             [-20, 0, 20]], np.float32),
                   np.tile([[0, 1, 0]], (4, 1)).astype(np.float32),
                   np.array([0, 2, 1, 0, 3, 2], np.uint32),  # up-facing winding
                   albedo=(0.8, 0.8, 0.8), smoothness=0.0)
        # two emitters; the table (size 1) holds only the stronger one
        b.add_sphere((-3, 5, 0), 2.0, (0, 0, 0), emission=(1, 1, 1),
                     emission_strength=10.0)
        b.add_sphere((3, 5, 0), 2.0, (0, 0, 0), emission=(1, 1, 1),
                     emission_strength=8.0)
        return b.build()

    scene = make_scene()
    lt = build_light_table(scene)
    assert np.asarray(lt.entry_valid).sum() == 1

    cam = rt.Camera(origin=(0, 8, 12), look_at=(0, 0, 0), aspect=1.0)
    from ray_tracer.renderer import render_progressive, camera_basis
    basis = camera_basis(cam)
    means = {}
    for nee in (False, True):
        params = rt.RenderParams(width=16, height=16, bounces=2, skybox=False,
                                 backend="jnp", nee=nee)
        img = np.asarray(render_progressive(scene, basis, params, 192))
        means[nee] = float(img.mean())
    # NEE must not change the converged image; with the r1 bug the
    # out-of-table emitter was suppressed (measured ratio 0.915 under the
    # old blanket suppression vs 1.002 fixed — 0.04 separates them)
    assert abs(means[True] / means[False] - 1.0) < 0.04, means


# ---------------------------------------------------------------------------
# Glossy NEE: exact lerp-lobe pdf (VERDICT r2 #8)
# ---------------------------------------------------------------------------

def _numeric_pdf(h, r, n, s, cosine):
    """Reference pdf at omega(h) by numeric change-of-variables: sum over
    BOTH preimage sheets of p_h(h_i) * (area at h_i) / (area at omega)."""
    from ray_tracer.lights import TWO_PI

    def to_omega(hv):
        v = (1.0 - s) * hv + s * r
        return v / np.linalg.norm(v)

    omega = to_omega(h)
    c = float(omega @ r)
    disc = s * s * (c * c - 1.0) + (1.0 - s) ** 2
    total = 0.0
    for sign in (1.0, -1.0):
        t = s * c + sign * np.sqrt(max(disc, 0.0))
        if t <= 1e-9:
            continue
        hi = (t * omega - s * r) / (1.0 - s)
        hi = hi / np.linalg.norm(hi)
        cos_hn = float(hi @ n)
        if cos_hn <= 0.0:
            continue
        p_h = cos_hn / np.pi if cosine else 1.0 / float(TWO_PI)
        # numeric area ratio via tangent perturbations at hi
        e1 = np.cross(hi, [0.0, 1.0, 0.0])
        if np.linalg.norm(e1) < 1e-6:
            e1 = np.cross(hi, [1.0, 0.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(hi, e1)
        eps = 1e-5
        h1 = (hi + eps * e1) / np.linalg.norm(hi + eps * e1)
        h2 = (hi + eps * e2) / np.linalg.norm(hi + eps * e2)
        o0, o1, o2 = to_omega(hi), to_omega(h1), to_omega(h2)
        area_o = np.linalg.norm(np.cross(o1 - o0, o2 - o0))
        area_h = np.linalg.norm(np.cross(h1 - hi, h2 - hi))
        total += p_h * area_h / max(area_o, 1e-30)
    return omega, total


def test_glossy_mix_pdf_matches_numeric_jacobian():
    """glossy_mix_pdf must equal the numeric pushforward density of
    materials.scatter's lerp at random points — single-sheet (s < 1/2)
    and two-sheet (s > 1/2) regimes, uniform and cosine hemispheres."""
    from ray_tracer.lights import glossy_mix_pdf

    rng = np.random.default_rng(7)
    n = np.array([0.0, 0.0, 1.0])
    r = np.array([0.35, 0.2, 0.91])
    r = r / np.linalg.norm(r)
    for s in (0.0, 0.3, 0.55, 0.8):
        for cosine in (False, True):
            for _ in range(6):
                h = rng.normal(size=3)
                h[2] = abs(h[2]) + 0.05
                h = h / np.linalg.norm(h)
                omega, want = _numeric_pdf(h, r, n, s, cosine)
                got = float(glossy_mix_pdf(
                    jnp.asarray(omega, jnp.float32)[None, :],
                    jnp.asarray(r, jnp.float32)[None, :],
                    jnp.asarray(n, jnp.float32)[None, :],
                    jnp.full((1,), s, jnp.float32), cosine)[0])
                assert abs(got - want) <= 2e-3 + 0.02 * abs(want), (
                    s, cosine, got, want)


def test_glossy_mix_pdf_integrates_to_one():
    """Lat-long quadrature of the lobe pdf over the sphere ~ 1."""
    from ray_tracer.lights import glossy_mix_pdf

    n = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    r = jnp.asarray([0.35, 0.2, 0.91], jnp.float32)
    r = r / jnp.linalg.norm(r)
    nth, nph = 1200, 600
    th = (np.arange(nth) + 0.5) / nth * np.pi          # polar from +z
    ph = (np.arange(nph) + 0.5) / nph * 2.0 * np.pi
    T, P = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                     np.cos(T)], -1).reshape(-1, 3).astype(np.float32)
    w = (np.sin(T) * (np.pi / nth) * (2.0 * np.pi / nph)).reshape(-1)
    R = dirs.shape[0]
    for s in (0.0, 0.3, 0.6):
        for cosine in (False, True):
            pdf = np.asarray(glossy_mix_pdf(
                jnp.asarray(dirs), jnp.broadcast_to(r, (R, 3)),
                jnp.broadcast_to(n, (R, 3)),
                jnp.full((R,), s, jnp.float32), cosine))
            integral = float((pdf * w).sum())
            assert abs(integral - 1.0) < 2e-2, (s, cosine, integral)


def test_nee_glossy_converged_unbiased():
    """The converged A/B from VERDICT r2 #8: a GLOSSY floor (0 < s < 1)
    under an emissive sphere — NEE on and off must agree (the old diffuse
    approximation biased every glossy blend; the exact lerp-lobe pdf
    removes the bias). Also pins that the cutoff is bias-free: excluding
    the glossy lanes via nee_smoothness_cutoff converges to the same
    image too."""
    b = rt.SceneBuilder()
    b.add_sphere((0, -100.0, 0), 99.0, (0.8, 0.8, 0.8), smoothness=0.5)
    b.add_sphere((0, 4.0, 0), 2.0, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=5.0)
    scene = b.build(pad=8)
    cam = rt.Camera(origin=(0, 2.2, 8.0), look_at=(0, 0.5, 0), fov=35.0,
                    aspect=1.0)
    base = rt.RenderParams(width=24, height=24, bounces=2, skybox=False,
                           backend="jnp")
    m_off, v_off = _mean_image(scene, cam, base, 160)
    m_on, v_on = _mean_image(scene, cam, base.replace(nee=True), 160)
    m_cut, _ = _mean_image(
        scene, cam, base.replace(nee=True, nee_smoothness_cutoff=0.3), 160)
    # the r2 diffuse approximation put the NEE/BSDF ratio visibly off on
    # glossy blends; exact pdf brings it within sampling error
    assert abs(m_on.mean() - m_off.mean()) < 0.015, (m_on.mean(), m_off.mean())
    assert abs(m_cut.mean() - m_off.mean()) < 0.015, (m_cut.mean(), m_off.mean())
    # On a tight glossy lobe (s=0.5) with a big, BSDF-easy emitter the
    # variance win is small (measured ~7%) — pin only that NEE is not
    # WORSE; the large-reduction claim lives on the diffuse test above
    lit = m_off.mean(-1) > 0.01
    assert v_on[lit].mean() < v_off[lit].mean() * 1.05


def test_mis_converged_unbiased():
    """Balance-heuristic MIS (VERDICT r3 #8) must not change the converged
    image: BSDF-only, NEE with pure suppression (mis=False), and NEE with
    MIS (default) all estimate the same transport integral — on a GLOSSY
    floor where the two strategies' pdfs genuinely compete."""
    b = rt.SceneBuilder()
    b.add_sphere((0, -100.0, 0), 99.0, (0.8, 0.8, 0.8), smoothness=0.6)
    b.add_sphere((0, 4.0, 0), 2.0, (0, 0, 0), emission=(1, 1, 1),
                 emission_strength=5.0)
    scene = b.build(pad=8)
    cam = rt.Camera(origin=(0, 2.2, 8.0), look_at=(0, 0.5, 0), fov=35.0,
                    aspect=1.0)
    base = rt.RenderParams(width=24, height=24, bounces=2, skybox=False,
                           backend="jnp")
    m_off, _ = _mean_image(scene, cam, base, 160)
    m_sup, _ = _mean_image(scene, cam, base.replace(nee=True, mis=False),
                           160)
    m_mis, _ = _mean_image(scene, cam, base.replace(nee=True), 160)
    assert abs(m_mis.mean() - m_off.mean()) < 0.015, (m_mis.mean(),
                                                      m_off.mean())
    assert abs(m_mis.mean() - m_sup.mean()) < 0.015, (m_mis.mean(),
                                                      m_sup.mean())


def test_mis_kills_near_mirror_variance_cliff():
    """The cliff VERDICT r3 flagged: under pure suppression, a near-mirror
    surface (s -> 1, below the cutoff) hands the whole direct integral to
    area-sampled NEE, which is catastrophically noisy inside a tight lobe.
    Measured on this scene (camera aimed at the emitter's mirror image on
    a glossy floor, 100 frames): suppression variance 1345 at s=0.9 and
    5098 at s=0.97 vs BSDF-only 1.8 / 1.0 — a 700-5000x cliff. With
    balance-heuristic MIS the BSDF strategy keeps the weight where its
    pdf dominates: variance stays within ~10% of BSDF-only at high s and
    BEATS both strategies at low/mid s."""
    def scene_at(s):
        b = rt.SceneBuilder()
        b.add_sphere((0, -100.0, 0), 99.0, (0.8, 0.8, 0.8), smoothness=s)
        b.add_sphere((0, 4.0, 0), 2.0, (0, 0, 0), emission=(1, 1, 1),
                     emission_strength=5.0)
        return b.build(pad=8)

    # look at the point on the floor where the emitter's reflection is —
    # the geometry where the two strategies genuinely compete
    cam = rt.Camera(origin=(0, 2.2, 8.0), look_at=(0, -1.0, 4.9), fov=30.0,
                    aspect=1.0)
    base = rt.RenderParams(width=16, height=16, bounces=1, skybox=False,
                           backend="jnp")
    for s, cliff in ((0.5, 1.5), (0.9, 50.0), (0.97, 50.0)):
        scene = scene_at(s)
        m_b, v_bsdf = _mean_image(scene, cam, base, 100)
        _, v_sup = _mean_image(scene, cam,
                               base.replace(nee=True, mis=False), 100)
        m_m, v_mis = _mean_image(scene, cam, base.replace(nee=True), 100)
        lit = m_b.mean(-1) > 0.01
        vb, vs, vm = (v_bsdf[lit].mean(), v_sup[lit].mean(),
                      v_mis[lit].mean())
        # MIS never meaningfully worse than the best single strategy
        assert vm <= min(vb, vs) * 1.20, (s, vb, vs, vm)
        # document the cliff MIS removes (suppression-only blows up)
        assert vs >= vm * cliff, (s, vs, vm)
        # and the mean stays unbiased
        assert abs(m_m.mean() - m_b.mean()) < 0.06 * max(m_b.mean(), 1e-3)


def test_mis_with_compaction_bitexact():
    """The MIS carry (prev_pdf, the previous scatter's lobe pdf) must ride
    the wavefront-compaction reorder with the rest of the per-lane state:
    octant-compacted NEE+MIS render == uncompacted, bit for bit (per-lane
    RNG travels with the lane; radiance scatters back by original slot)."""
    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = rt.camera_basis(cam)
    base = rt.RenderParams(width=32, height=32, bounces=2, skybox=True,
                           nee=True, backend="pallas", interpret=True)
    a = np.asarray(render_frame(scene, basis, base, jnp.int32(0)))
    b = np.asarray(render_frame(scene, basis,
                                base.replace(compaction="octant"),
                                jnp.int32(0)))
    np.testing.assert_array_equal(a, b)


def test_nee_unbiased_on_room_quirk_normals():
    """r4 bias regression: the room's hand-authored shading normals tilt
    AWAY from the ceiling light on whole walls while the reference's lerp
    lobe still reaches it. A shading-side cos>0 gate zeroed NEE there
    while suppressing (or MIS-down-weighting) the live BSDF path —
    measured 7% total image energy loss, identical with and without MIS.
    NEE (both estimators) must match BSDF-only on the converged room."""
    from ray_tracer.renderer import render_progressive

    scene, cam = rt.builtin_scene("room", aspect=1.0)
    basis = rt.camera_basis(cam)
    base = rt.RenderParams(width=24, height=24, bounces=2, skybox=False,
                           backend="jnp")
    means = {}
    for key, kw in (("off", {}), ("mis", dict(nee=True)),
                    ("sup", dict(nee=True, mis=False))):
        img = np.asarray(render_progressive(scene, basis,
                                            base.replace(**kw), 400))
        means[key] = float(img.mean())
    assert abs(means["mis"] / means["off"] - 1.0) < 0.02, means
    assert abs(means["sup"] / means["off"] - 1.0) < 0.02, means
