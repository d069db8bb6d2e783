"""Coverage-kernel <-> XLA parity sweep + golden-image regression.

Randomized scenes (near-plane crossers, degenerates, batches, range
mode, peeling) at sizes that cross the kernel's pixel tiles, checking:

* binned coverage kernel (interpret) == XLA path: bit-identical ID
  buffers except at genuine z-fights, float-tolerance barys/derivatives;
* other tile sizes (other CSR layouts of the same records) == the
  default;
* committed golden renders of the sample workloads (tests/golden/*.npz)
  to catch any regression in the full 4-op pipeline.

Regenerate goldens: python tests/test_parity_sweep.py --regen
"""

import os
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.utils import camera

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _random_scene(seed, B=1, V=64, T=48, near_crossers=True,
                  degenerates=True):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.4, 2.5, (B, V))
    if near_crossers:
        k = max(2, V // 10)
        pos[:, :k, 3] = rng.uniform(-0.5, 0.1, (B, k))
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    if degenerates:
        tri[0] = [3, 3, 7]       # repeated vertex
        tri[1] = [5, 5, 5]       # fully degenerate
    return jnp.asarray(pos), jnp.asarray(tri)


def _assert_ids_match_mod_zfights(r_x, r_p, max_frac=2e-4):
    """ID buffers equal except where two triangles genuinely intersect
    (equal depths to float tolerance): there the winner is a true tie
    and the two routes' different merge orders may round differently.
    Non-tied pixels must agree exactly."""
    ix = np.asarray(r_x[..., 3])
    ip = np.asarray(r_p[..., 3])
    differ = ix != ip
    if differ.any():
        zx = np.asarray(r_x[..., 2])[differ]
        zp = np.asarray(r_p[..., 2])[differ]
        np.testing.assert_allclose(zx, zp, atol=1e-4, err_msg=(
            "ID mismatch at non-tied depth — real coverage divergence"))
        assert differ.mean() <= max_frac, (
            f"{differ.sum()} id mismatches — too many even for z-fights")
    return ~differ


@pytest.mark.parametrize("seed,res,B", [
    (0, (40, 300), 1),    # wide: many tile columns, partial last tile
    (1, (67, 130), 2),    # odd sizes, batch
    (2, (130, 96), 1),    # tall: several tile rows
    (3, (48, 64), 3),     # batch of 3
])
def test_rasterize_parity_sweep(seed, res, B):
    pos, tri = _random_scene(seed, B=B)
    r_x, db_x = dr.rasterize(None, pos, tri, res, impl="xla")
    r_p, db_p = dr.rasterize(None, pos, tri, res, impl="triton_interpret")
    same = _assert_ids_match_mod_zfights(r_x, r_p)
    # Adversarial random geometry (near-plane crossers -> huge screen
    # extents) stresses bary precision; coverage is the bitwise part.
    np.testing.assert_allclose(np.asarray(r_x)[same], np.asarray(r_p)[same],
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(db_x)[same],
                               np.asarray(db_p)[same], atol=1e-3)


def _kernel_ids(pos, tri, res, tile):
    """Kernel id buffer (+1, 0 empty) for another pixel-tile size."""
    from nvdiffrast_tpu.ops.coverage_kernel import coverage_binned

    ranges = jnp.broadcast_to(jnp.array([[0, tri.shape[0]]], jnp.int32),
                              (pos.shape[0], 2))
    idbuf, zbuf = coverage_binned(pos, tri, res, ranges, interpret=True,
                                  tile=tile)
    return np.asarray(idbuf) + 1, np.asarray(zbuf)


def test_rasterize_parity_many_tris():
    """A record stream far longer than one group per tile, and the
    same coverage from a different tile size (another CSR layout)."""
    pos_idx, vtxp, _, _ = primitives.uv_sphere(24, 48)  # ~2.2k tris
    tri = jnp.asarray(pos_idx)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.2)
    pos = jnp.asarray((posw @ mvp.T)[None].astype(np.float32))

    res = (96, 128)
    r_x, _ = dr.rasterize(None, pos, tri, res, impl="xla")
    r_p, _ = dr.rasterize(None, pos, tri, res, impl="triton_interpret")
    np.testing.assert_array_equal(np.asarray(r_x[..., 3]),
                                  np.asarray(r_p[..., 3]))
    ids16, _ = _kernel_ids(pos, tri, res, (16, 16))
    np.testing.assert_array_equal(ids16, np.asarray(r_p[..., 3]))


def test_rasterize_csr_batch():
    """Minibatch (vmapped layout, per-image segment tables) with
    overlapping random triangles: kernel == XLA mod z-fights, and
    16x64 tiles == default tiles."""
    pos, tri = _random_scene(11, B=2, T=400)
    res = (96, 128)
    r_x, _ = dr.rasterize(None, pos, tri, res, impl="xla")
    r_p, _ = dr.rasterize(None, pos, tri, res, impl="triton_interpret")
    _assert_ids_match_mod_zfights(r_x, r_p)
    ids, z = _kernel_ids(pos, tri, res, (16, 64))
    r_t = np.stack([np.zeros_like(z), np.zeros_like(z), z, ids], -1)
    _assert_ids_match_mod_zfights(np.asarray(r_p), r_t)


def _sliver_scene(seed, T=600, scale=3.0, half_len=2.0, width_px=0.05,
                  W=256):
    """Near-degenerate sliver triangles on distinct z planes (w = 1).

    Slivers whose clip coords reach ~scale make the edge-coefficient
    products large while the triangle stays ~width_px thin — exactly
    the shapes whose f32 coverage polytope can escape the projected
    vertex AABB (the round-3 on-chip CSR divergence). Distinct z per
    triangle means no depth ties anywhere, so every impl/path must
    produce bitwise-identical ID buffers.
    """
    rng = np.random.RandomState(seed)
    wfrac = width_px * 2.0 / W
    c = rng.uniform(-0.9, 0.9, (T, 2))
    th = rng.uniform(0, np.pi, T)
    d = np.stack([np.cos(th), np.sin(th)], -1) * half_len
    n = np.stack([-np.sin(th), np.cos(th)], -1)
    off = rng.uniform(0.2, 1.0, (T, 1)) * wfrac * scale
    v0 = c - d
    v1 = c + d
    v2 = c + rng.uniform(-0.5, 0.5, (T, 1)) * d + n * off
    pos = np.zeros((1, 3 * T, 4), np.float32)
    pos[0, 0::3, :2] = v0
    pos[0, 1::3, :2] = v1
    pos[0, 2::3, :2] = v2
    pos[0, :, 2] = np.repeat(np.linspace(-0.8, 0.8, T), 3)
    pos[0, :, 3] = 1.0
    tri = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    return jnp.asarray(pos), jnp.asarray(tri)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_sliver_exact_ids(seed):
    """Exact-id CSR invariant on a tie-free sliver-heavy scene.

    Binning soundness regression: a sliver's f32-coefficient coverage
    polytope can extend ~1 px outside its projected AABB, so without
    the binning.coverage_slop expansion the CSR segments and group-AABB
    tests drop pixels the kernel arithmetic covers. No z-fight escape
    hatch here: depths are distinct constants, the XLA scan and the
    kernel at two tile sizes must agree bitwise.
    """
    pos, tri = _sliver_scene(seed)
    res = (96, 128)
    r_x, _ = dr.rasterize(None, pos, tri, res, impl="xla")
    r_p, _ = dr.rasterize(None, pos, tri, res, impl="triton_interpret")
    ids_x = np.asarray(r_x[..., 3])
    assert (ids_x > 0).sum() > 50, "scene covers too little to test"
    np.testing.assert_array_equal(ids_x, np.asarray(r_p[..., 3]))
    np.testing.assert_array_equal(ids_x, _kernel_ids(pos, tri, res,
                                                     (16, 16))[0])


# Triangles found by a vectorized-f32 emulation of the kernel's exact
# record-coefficient + affine-eval arithmetic, hunting for triangles
# whose f32 coverage polytope claims a pixel center OUTSIDE the
# projected vertex AABB + 0.5 px binning pad at 256x256. Each row is one triangle's
# [x0,y0,z0,w0, x1,y1,z1,w1, x2,y2,z2,w2] clip coords, verbatim
# (repr round-trips float32 exactly).
#
# History: the first 32 rows were found against the round-4 plain-f32
# coefficient construction (32 escapees / 8M candidates). The round-5
# correctly-rounded _dop construction shrinks polytope drift to the
# 0.5-ulp + eval-rounding scale: re-searching 40M candidates under it
# found only 2 escapees — row 6 (shared with the old set) and the
# final row (new). The legacy rows are kept as sliver parity stress
# (most no longer cover any pixel at all — itself evidence of the
# accuracy win).
_ESCAPEE_VERTS = [
    [1.1497044563293457, 1.1547437906265259, -0.5420172214508057, 2.3586673736572266, 1.032828688621521, 1.3109936714172363, -0.5420172214508057, 2.3586673736572266, 1.0793559551239014, 1.2487906217575073, -0.5420172214508057, 2.3586673736572266],
    [0.735187828540802, 1.46221923828125, 0.11707647144794464, 2.193502426147461, 0.8007091283798218, 1.5943899154663086, 0.11707647144794464, 2.193502426147461, 0.7753080129623413, 1.5431513786315918, 0.11707647144794464, 2.193502426147461],
    [-0.8610252141952515, 0.8673174977302551, 0.5411399006843567, 1.6056082248687744, -0.7998149394989014, 0.8855802416801453, 0.5411399006843567, 1.6056082248687744, -0.8124189972877502, 0.8818199634552002, 0.5411399006843567, 1.6056082248687744],
    [1.7272032499313354, -1.4063154458999634, -0.6996694207191467, 2.8387246131896973, 1.4439154863357544, -1.3908721208572388, -0.6996694207191467, 2.8387246131896973, 1.507496953010559, -1.3943387269973755, -0.6996694207191467, 2.8387246131896973],
    [-2.4986109733581543, -2.2639691829681396, -1.3222558498382568, 2.8647470474243164, -2.3491244316101074, -2.157381772994995, -1.3222558498382568, 2.8647470474243164, -2.396876811981201, -2.191429376602173, -1.3222558498382568, 2.8647470474243164],
    [-1.3426345586776733, 0.8090986609458923, 0.08231264352798462, 2.0337204933166504, -1.2999699115753174, 0.9451133012771606, 0.08231264352798462, 2.0337204933166504, -1.3276619911193848, 0.8568321466445923, 0.08231264352798462, 2.0337204933166504],
    [-2.0718743801116943, -2.104811191558838, 1.1743773221969604, 2.6706347465515137, -2.171807289123535, -1.9308369159698486, 1.1743773221969604, 2.6706347465515137, -2.123167037963867, -2.0155160427093506, 1.1743773221969604, 2.6706347465515137],
    [-0.5148428678512573, 0.5684653520584106, 0.26545727252960205, 0.8039409518241882, -0.5663204193115234, 0.5728920102119446, 0.26545727252960205, 0.8039409518241882, -0.5325137972831726, 0.5699848532676697, 0.26545727252960205, 0.8039409518241882],
    [-0.39924320578575134, -0.7978526949882507, -0.392722487449646, 0.9601472616195679, -0.35886672139167786, -0.6314884424209595, -0.392722487449646, 0.9601472616195679, -0.38736358284950256, -0.7489020824432373, -0.392722487449646, 0.9601472616195679],
    [-0.837623119354248, 0.7509583234786987, -0.30380895733833313, 1.437072515487671, -0.8558405041694641, 0.7959389686584473, -0.30380895733833313, 1.437072515487671, -0.8517334461212158, 0.7857977747917175, -0.30380895733833313, 1.437072515487671],
    [0.8754037022590637, -1.293457269668579, -0.4293598532676697, 2.210223913192749, 1.0236140489578247, -1.2246559858322144, -0.4293598532676697, 2.210223913192749, 0.9845557808876038, -1.2427871227264404, -0.4293598532676697, 2.210223913192749],
    [0.4866711497306824, 0.6153087615966797, -0.33098065853118896, 0.8054631352424622, 0.4817899465560913, 0.7125476002693176, -0.33098065853118896, 0.8054631352424622, 0.4849991798400879, 0.6486057043075562, -0.33098065853118896, 0.8054631352424622],
    [1.7255836725234985, 1.5938167572021484, 0.20955929160118103, 2.110520839691162, 1.395212173461914, 1.6212158203125, 0.20955929160118103, 2.110520839691162, 1.5839259624481201, 1.605563998222351, 0.20955929160118103, 2.110520839691162],
    [-1.1160228252410889, 1.3448578119277954, -0.4855857193470001, 2.3936173915863037, -1.0241087675094604, 1.391598105430603, -0.4855857193470001, 2.3936173915863037, -1.0757876634597778, 1.3653192520141602, -0.4855857193470001, 2.3936173915863037],
    [-1.84355628490448, 1.1650645732879639, 0.5186352133750916, 2.4391863346099854, -1.6708261966705322, 1.2278472185134888, 0.5186352133750916, 2.4391863346099854, -1.7876379489898682, 1.1853899955749512, 0.5186352133750916, 2.4391863346099854],
    [0.5750769972801208, -0.358078271150589, -0.05923350155353546, 0.8541847467422485, 0.6334949135780334, -0.34586694836616516, -0.05923350155353546, 0.8541847467422485, 0.608935534954071, -0.35099995136260986, -0.05923350155353546, 0.8541847467422485],
    [0.8185862302780151, -1.2600687742233276, -0.21175555884838104, 1.7567062377929688, 0.5871995687484741, -1.1958539485931396, -0.21175555884838104, 1.7567062377929688, 0.6378446221351624, -1.2099100351333618, -0.21175555884838104, 1.7567062377929688],
    [0.8959750533103943, -0.9356057643890381, -0.5105183720588684, 1.391391396522522, 0.8094224333763123, -0.9152399301528931, -0.5105183720588684, 1.391391396522522, 0.8691112399101257, -0.9292851090431213, -0.5105183720588684, 1.391391396522522],
    [-1.1060261726379395, -1.251795768737793, -0.360465943813324, 1.7094870805740356, -1.1746399402618408, -1.1709754467010498, -0.360465943813324, 1.7094870805740356, -1.1420553922653198, -1.209357500076294, -0.360465943813324, 1.7094870805740356],
    [-0.7426087260246277, 0.5409913659095764, 0.3731740117073059, 0.9207356572151184, -0.6955878734588623, 0.5520586967468262, 0.3731740117073059, 0.9207356572151184, -0.7177333235740662, 0.5468466877937317, 0.3731740117073059, 0.9207356572151184],
    [-0.33895552158355713, -1.3299885988235474, 0.47306227684020996, 1.667863368988037, -0.3855016529560089, -1.2946118116378784, 0.47306227684020996, 1.667863368988037, -0.35708412528038025, -1.3162107467651367, 0.47306227684020996, 1.667863368988037],
    [-1.075717806816101, 1.1878288984298706, 0.8216635584831238, 1.7361458539962769, -0.8033077716827393, 1.4224910736083984, 0.8216635584831238, 1.7361458539962769, -0.863835871219635, 1.3703522682189941, 0.8216635584831238, 1.7361458539962769],
    [-1.0908560752868652, 0.723088800907135, -0.017992522567510605, 1.2937395572662354, -0.9946235418319702, 0.725598156452179, -0.017992522567510605, 1.2937395572662354, -1.0318777561187744, 0.7246270775794983, -0.017992522567510605, 1.2937395572662354],
    [1.2260550260543823, 1.1572610139846802, 0.5731396079063416, 1.6023668050765991, 1.3818732500076294, 1.2498266696929932, 0.5731396079063416, 1.6023668050765991, 1.3284125328063965, 1.2180691957473755, 0.5731396079063416, 1.6023668050765991],
    [1.1943893432617188, -1.783500075340271, -0.6245840787887573, 2.7067646980285645, 1.5261540412902832, -1.455221176147461, -0.6245840787887573, 2.7067646980285645, 1.3483375310897827, -1.6311671733856201, -0.6245840787887573, 2.7067646980285645],
    [-1.8521349430084229, 1.5869942903518677, -0.8933380246162415, 2.3838284015655518, -1.7374438047409058, 1.5902936458587646, -0.8933380246162415, 2.3838284015655518, -1.7911969423294067, 1.5887489318847656, -0.8933380246162415, 2.3838284015655518],
    [0.9085796475410461, 0.38819700479507446, -0.7071779370307922, 1.7051481008529663, 0.9504688382148743, 0.42631202936172485, -0.7071779370307922, 1.7051481008529663, 0.9230412840843201, 0.4013565480709076, -0.7071779370307922, 1.7051481008529663],
    [-0.7426233291625977, -0.7107279300689697, 0.4534553289413452, 0.9818525910377502, -0.7714287638664246, -0.6263455152511597, 0.4534553289413452, 0.9818525910377502, -0.763208270072937, -0.6504271626472473, 0.4534553289413452, 0.9818525910377502],
    [0.34227120876312256, -1.4239169359207153, -0.08906707167625427, 1.7015235424041748, 0.45213624835014343, -1.3901572227478027, -0.08906707167625427, 1.7015235424041748, 0.41988489031791687, -1.4000673294067383, -0.08906707167625427, 1.7015235424041748],
    [1.7105032205581665, -1.6630570888519287, -0.09948603063821793, 2.561558485031128, 1.77471923828125, -1.366410255432129, -0.09948603063821793, 2.561558485031128, 1.739441156387329, -1.5293715000152588, -0.09948603063821793, 2.561558485031128],
    [-0.41994547843933105, 0.46749597787857056, -0.2807263135910034, 0.5885091423988342, -0.4685002863407135, 0.5110995173454285, -0.2807263135910034, 0.5885091423988342, -0.4326794445514679, 0.47893109917640686, -0.2807263135910034, 0.5885091423988342],
    [-0.6452283263206482, 0.21741968393325806, 0.5492311120033264, 1.2254729270935059, -0.6090529561042786, 0.2896687090396881, 0.5492311120033264, 1.2254729270935059, -0.6346070170402527, 0.23863281309604645, 0.5492311120033264, 1.2254729270935059],
    [1.9500236511230469, -1.8362715244293213, 0.5271088480949402, 2.422553062438965, 2.1137914657592773, -1.6896483898162842, 0.5271088480949402, 2.422553062438965, 2.045605421066284, -1.7506954669952393, 0.5271088480949402, 2.422553062438965],
]


def test_csr_escapee_exact_ids():
    """Known binning-escape triangles must render identically on every
    route (CSR 1-pixel divergence regression).

    These triangles' f32 coverage polytopes provably reach outside
    their padded screen AABBs, so any binning that ignores the
    coefficient-rounding slop (binning.coverage_slop) drops the escaped
    pixel. Depths are remapped to distinct per-triangle constants: zero
    z-fights, bitwise equality required.
    """
    v = np.asarray(_ESCAPEE_VERTS, np.float32).reshape(-1, 3, 4)
    T = v.shape[0]
    # Distinct per-triangle depth planes (z/w constant per triangle,
    # well inside |z| <= w): depth never decides coverage here and no
    # two triangles can tie.
    zfrac = np.linspace(-0.45, 0.45, T, dtype=np.float32)
    v[..., 2] = zfrac[:, None] * v[..., 3]
    pos = jnp.asarray(v.reshape(1, -1, 4))
    tri = jnp.asarray(np.arange(3 * T, dtype=np.int32).reshape(T, 3))

    res = (256, 256)
    r_x, _ = dr.rasterize(None, pos, tri, res, impl="xla")
    r_p, _ = dr.rasterize(None, pos, tri, res, impl="triton_interpret")
    ids_x = np.asarray(r_x[..., 3])
    # Each escapee covers ~1 px; a few may overlap another's pixel.
    # Under the correctly-rounded construction most legacy slivers no
    # longer cover anything; at least the re-confirmed escapee must.
    assert (ids_x > 0).sum() >= 1, "no sliver covers any pixel"
    np.testing.assert_array_equal(ids_x, np.asarray(r_p[..., 3]))
    np.testing.assert_array_equal(ids_x, _kernel_ids(pos, tri, res,
                                                     (16, 16))[0])


def test_peeling_parity_random():
    # Triangles on distinct z planes (w = 1): plenty of overlap in
    # screen space for peeling, but no 3-D intersections, so no
    # genuine depth ties and layer contents must match exactly.
    rng = np.random.RandomState(7)
    B, T = 2, 30
    tri_np = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    pos_np = rng.uniform(-1, 1, (B, 3 * T, 4)).astype(np.float32)
    pos_np[..., 3] = 1.0
    z_planes = np.linspace(-0.8, 0.8, T).astype(np.float32)
    for t in range(T):
        pos_np[:, 3 * t:3 * t + 3, 2] = z_planes[t]
    pos, tri = jnp.asarray(pos_np), jnp.asarray(tri_np)
    outs = {}
    for impl in ("xla", "triton_interpret"):
        with dr.DepthPeeler(dr.RasterizeCudaContext(), pos, tri, (67, 96),
                            impl=impl) as peeler:
            layers = [np.asarray(peeler.rasterize_next_layer()[0])
                      for _ in range(3)]
        outs[impl] = layers
    for a, b in zip(outs["xla"], outs["triton_interpret"]):
        np.testing.assert_array_equal(a[..., 3], b[..., 3])
        np.testing.assert_allclose(a, b, atol=1e-5)


# ---------------------------------------------------------------------------
# Golden renders of the sample workloads.
# ---------------------------------------------------------------------------

def _workload_images():
    """Deterministic small renders of the five sample workloads."""
    out = {}

    # triangle
    pos = jnp.asarray([[[-0.8, -0.8, 0, 1], [0.8, -0.8, 0, 1],
                        [-0.8, 0.8, 0, 1]]], jnp.float32)
    col = jnp.asarray([[[1, 0, 0], [0, 1, 0], [0, 0, 1]]], jnp.float32)
    tri = jnp.asarray([[0, 1, 2]], jnp.int32)
    rast, _ = dr.rasterize(None, pos, tri, (64, 64))
    img, _ = dr.interpolate(col, rast, tri)
    out["triangle"] = img

    # cube (color interpolation + AA)
    pos_idx, vtxp, col_idx, _ = primitives.cube_continuous()
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = (camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
           @ camera.rotate_y(0.7) @ camera.rotate_x(0.4))
    p = jnp.asarray((posw @ mvp.T)[None].astype(np.float32))
    t = jnp.asarray(pos_idx)
    rast, _ = dr.rasterize(None, p, t, (64, 64))
    img, _ = dr.interpolate(jnp.asarray((vtxp * 0.5 + 0.5)[None],), rast,
                            jnp.asarray(col_idx))
    out["cube"] = dr.antialias(img, rast, p, t)

    # earth-style (uv texture, trilinear mip)
    pos_idx, vtxp, uv_idx, vtxu = primitives.uv_sphere(12, 24)
    tex = primitives.checkerboard_texture(32, 64)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    p = jnp.asarray((posw @ mvp.T)[None].astype(np.float32))
    t = jnp.asarray(pos_idx)
    rast, rast_db = dr.rasterize(None, p, t, (64, 64))
    texc, texd = dr.interpolate(jnp.asarray(vtxu)[None], rast,
                                jnp.asarray(uv_idx), rast_db=rast_db,
                                diff_attrs="all")
    out["earth"] = dr.texture(jnp.asarray(tex)[None], texc, texd,
                              filter_mode="linear-mipmap-linear")

    # envphong-style (cube map)
    rng = np.random.RandomState(0)
    env = jnp.asarray(rng.rand(1, 6, 16, 16, 3).astype(np.float32))
    view = jnp.asarray(vtxp.astype(np.float32))  # fake reflection vecs
    refl, _ = dr.interpolate(view[None], rast, t)
    out["envphong"] = dr.texture(env, refl, filter_mode="linear",
                                 boundary_mode="cube")

    # pose-style (silhouette + AA, different rotation)
    mvp2 = (camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
            @ camera.rotate_x(-0.6) @ camera.rotate_y(0.3))
    pos_idx, vtxp, col_idx, _ = primitives.cube_continuous()
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    p = jnp.asarray((posw @ mvp2.T)[None].astype(np.float32))
    t = jnp.asarray(pos_idx)
    rast, _ = dr.rasterize(None, p, t, (48, 48))
    sil = jnp.clip(rast[..., 3:], 0, 1)
    out["pose"] = dr.antialias(sil, rast, p, t)

    return {k: np.asarray(v) for k, v in out.items()}


def test_golden_renders():
    imgs = _workload_images()
    path = GOLDEN / "workloads.npz"
    assert path.exists(), (
        "golden file missing; run `python tests/test_parity_sweep.py "
        "--regen` and commit tests/golden/workloads.npz")
    ref = np.load(path)
    for k, v in imgs.items():
        np.testing.assert_allclose(
            v, ref[k], atol=1e-5, rtol=1e-5,
            err_msg=f"workload {k!r} drifted from golden render")


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        GOLDEN.mkdir(exist_ok=True)
        np.savez_compressed(GOLDEN / "workloads.npz", **_workload_images())
        print(f"wrote {GOLDEN / 'workloads.npz'}")
