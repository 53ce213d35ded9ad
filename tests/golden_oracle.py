"""Independent NumPy oracle of the reference's NCC objective path.

A scalar-per-patch transliteration written directly from the reference
semantics (the reference C++ is not buildable here: no Eigen/CImg/NLopt
headers), shared by tests/test_golden_parity.py and chip_smoke.py:

  - image pyramid          image/image.cpp:245-315 (buildImagePyramid)
  - camera axes/ipscale    image/camera.cpp:65-89, pmmvps/optim.cpp:43-65
  - per-level projection   image/camera.cpp:91-100, 310-326
  - getUnit / getPAxes     pmmvps/optim.cpp:34-41, 67-84
  - getTex (level shift,
    border, lattice)       pmmvps/optim.cpp:790-844, 895-915
  - bilinear getColor      image/image.cpp:465-475
  - normalize / dot        pmmvps/optim.cpp:917-940, 601-609
  - robustincc             pmmvps/optim.cpp:622-624
  - cost_func (pairwise=0) pmmvps/optim.cpp:401-468

It imports nothing from the engine; `planes_by_view` only re-shapes the
Scene's flat pyramid storage, whose construction is itself checked
against `oracle_downsample`.
"""

import math

import numpy as np

# ----------------------------------------------------------------------
# oracle: pyramid (image.cpp:245-315, filter=0)
# ----------------------------------------------------------------------


def oracle_downsample(img: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8-valued floats -> one level down, re-quantized.

    Taps at parent coordinates 2y+i, 2x+j for i,j in [-1, 3); taps with
    ytmp < 0 or ytmp > h-1 are skipped (the *last* parent row/column
    DOES contribute: the guard is `h - 1 < ytmp`, image.cpp:268-277).
    No weight renormalization for skipped taps."""
    k = np.array([1.0, 3.0, 3.0, 1.0])
    w2 = np.outer(k, k) / 64.0
    h, w, c = img.shape
    ho, wo = h // 2, w // 2
    out = np.zeros((ho, wo, c), np.float64)
    for y in range(ho):
        for x in range(wo):
            acc = np.zeros(c)
            for i in range(-1, 3):
                yt = 2 * y + i
                if yt < 0 or h - 1 < yt:
                    continue
                for j in range(-1, 3):
                    xt = 2 * x + j
                    if xt < 0 or w - 1 < xt:
                        continue
                    acc += w2[i + 1, j + 1] * img[yt, xt]
            out[y, x] = acc
    return np.floor(out + 0.5)  # image.cpp:308-310 uint8 re-quantization


# ----------------------------------------------------------------------
# oracle: camera quantities (camera.cpp:65-89, optim.cpp:43-65)
# ----------------------------------------------------------------------


class OracleCam:
    def __init__(self, P0: np.ndarray):
        P0 = np.asarray(P0, np.float64)
        self.P0 = P0
        M = P0[:, :3]
        self.center = np.append(-np.linalg.solve(M, P0[:, 3]), 1.0)
        oaxis = P0[2] / np.linalg.norm(P0[2, :3])
        self.zaxis = oaxis[:3]
        xaxis = P0[0, :3]
        yaxis = np.cross(self.zaxis, xaxis)
        yaxis /= np.linalg.norm(yaxis)
        self.yaxis = yaxis
        self.xaxis = np.cross(yaxis, self.zaxis)
        fx = P0[0, :3] @ self.xaxis  # w-components are 0 (optim.cpp:59-62)
        fy = P0[1, :3] @ self.yaxis
        self.ipscale = fx + fy

    def proj_level(self, level: int) -> np.ndarray:
        P = self.P0.copy()
        P[0] /= 2.0 ** level
        P[1] /= 2.0 ** level
        return P

    def project(self, coord: np.ndarray, level: int) -> np.ndarray:
        ic = self.proj_level(level) @ coord
        if ic[2] <= 0.0:
            return np.array([-0xFFFF, -0xFFFF, -1.0])  # camera.cpp:313-316
        return ic / ic[2]

    def get_unit(self, coord: np.ndarray, level: int) -> float:
        fz = np.linalg.norm(coord - self.center)
        if self.ipscale == 0.0:
            return 1.0
        return 2.0 * fz * (1 << level) / self.ipscale


def oracle_paxes(cam: OracleCam, coord, normal, level):
    """Optim::getPAxes (optim.cpp:67-84)."""
    pscale = cam.get_unit(coord, level)
    n3 = normal[:3]
    y3 = np.cross(n3, cam.xaxis)
    y3 /= np.linalg.norm(y3)
    x3 = np.cross(y3, n3)
    px = np.append(x3, 0.0) * pscale
    py = np.append(y3, 0.0) * pscale
    xdis = np.linalg.norm(cam.project(coord + px, level) - cam.project(coord, level))
    ydis = np.linalg.norm(cam.project(coord + py, level) - cam.project(coord, level))
    return px / xdis, py / ydis


# ----------------------------------------------------------------------
# oracle: getTex + bilinear fetch + normalize + cost
# ----------------------------------------------------------------------


def oracle_bilinear(plane: np.ndarray, x: float, y: float) -> np.ndarray:
    """image.cpp:465-475: truncating int cast + 2x2 lerp."""
    lx, ly = int(x), int(y)
    dx1, dy1 = x - lx, y - ly
    dx0, dy0 = 1.0 - dx1, 1.0 - dy1
    return (
        plane[ly, lx] * (dx0 * dy0)
        + plane[ly + 1, lx] * (dx0 * dy1)
        + plane[ly, lx + 1] * (dx1 * dy0)
        + plane[ly + 1, lx + 1] * (dx1 * dy1)
    )


def oracle_get_tex(cam, planes, coord, px, py, normal, level, wsize, cos_a1):
    """Optim::getTex (optim.cpp:790-844) for one view. Returns
    [S, 3] window or None (flag == -1)."""
    ray = cam.center - coord
    ray = ray / np.linalg.norm(ray)
    weight = max(0.0, float(ray @ normal))
    if weight < cos_a1:
        return None

    margin = wsize // 2
    center = cam.project(coord, level)
    dx = cam.project(coord + px, level) - center
    dy = cam.project(coord + py, level) - center
    ratio = (np.linalg.norm(dx) + np.linalg.norm(dy)) / 2.0
    level_diff = int(math.floor(math.log(ratio) / math.log(2.0) + 0.5))
    level_diff = max(-level, min(2, level_diff))
    scale = 2.0 ** level_diff
    new_level = level + level_diff
    center, dx, dy = center / scale, dx / scale, dy / scale

    # getTexSafe (optim.cpp:895-915)
    h, w = planes[new_level].shape[:2]
    corners = [
        center - dx * margin - dy * margin,
        center + dx * margin - dy * margin,
        center - dx * margin + dy * margin,
        center + dx * margin + dy * margin,
    ]
    minx = min(c[0] for c in corners)
    maxx = max(c[0] for c in corners)
    miny = min(c[1] for c in corners)
    maxy = max(c[1] for c in corners)
    margin2 = 2
    if minx < margin2 or w - 1 - margin2 <= maxx or miny < margin2 or h - 1 - margin2 <= maxy:
        return None

    tl = center - dx * margin - dy * margin
    tex = np.zeros((wsize * wsize, 3))
    for yy in range(wsize):
        for xx in range(wsize):
            samp = tl + dx * xx + dy * yy
            tex[yy * wsize + xx] = oracle_bilinear(planes[new_level], samp[0], samp[1])
    return tex


def oracle_normalize(tex):
    """optim.cpp:917-940."""
    ave = tex.mean(axis=0)
    diff = tex - ave
    msd = math.sqrt((diff * diff).sum() / (3 * tex.shape[0]))
    if msd == 0.0:
        msd = 1.0
    return diff / msd


def oracle_cost(cams, planes_by_view, coord, normal, views, level, wsize,
                tau, minimum, angle_threshold1):
    """cost_func, pairwise=0 (optim.cpp:401-468)."""
    cos_a1 = math.cos(angle_threshold1)
    views = [v for v in views if v >= 0]
    sz = min(tau, len(views))
    minimum = min(minimum, sz)
    px, py = oracle_paxes(cams[views[0]], coord, normal, level)
    texs = []
    for i in range(sz):
        t = oracle_get_tex(
            cams[views[i]], planes_by_view[views[i]], coord, px, py,
            normal, level, wsize, cos_a1,
        )
        texs.append(None if t is None else oracle_normalize(t))
    if texs[0] is None:
        return 2.0
    ans, denom = 0.0, 0
    for i in range(1, sz):
        if texs[i] is None:
            continue
        d = (texs[0] * texs[i]).sum() / (3 * wsize * wsize)
        incc = 1.0 - d
        ans += incc / (1 + 3 * incc)
        denom += 1
    if denom < minimum - 1:
        return 2.0
    return ans / denom


def planes_by_view(scene, illum: int = 0):
    """Per-view lists of per-level [h, w, 3] float64 arrays re-shaped
    from the Scene's flat plane storage (the engine's texture source)."""
    widths = [int(x) for x in np.asarray(scene.lvl_widths)]
    heights = [int(x) for x in np.asarray(scene.lvl_heights)]
    offs = [int(x) for x in np.asarray(scene.lvl_offsets)]
    planes = np.asarray(scene.planes)  # [views, illums, flat, 3]
    out = []
    for v in range(planes.shape[0]):
        lv = []
        for l in range(len(widths)):
            flat = planes[v, illum, offs[l] : offs[l] + widths[l] * heights[l]]
            lv.append(flat.reshape(heights[l], widths[l], 3).astype(np.float64))
        out.append(lv)
    return out


def oracle_costs(Ps, planes, coord, normal, views, level, wsize, tau,
                 minimum, angle_threshold1):
    """oracle_cost for every row of a [B, T] view-list batch.
    Ps: [V, 3, 4] projections; planes: planes_by_view output."""
    cams = [OracleCam(P) for P in Ps]
    coord = np.asarray(coord, np.float64)
    normal = np.asarray(normal, np.float64)
    return np.array([
        oracle_cost(cams, planes, coord[b], normal[b], list(views[b]),
                    level, wsize, tau, minimum, angle_threshold1)
        for b in range(coord.shape[0])
    ])


def compare_costs(engine_cost, oracle_cost_arr):
    """(worst |engine - oracle| over rows both score, number of rows
    either scores 2.0, number of rows whose validity disagrees). A row
    is invalid (2.0) when its reference window or too few others are."""
    ec = np.asarray(engine_cost, np.float64)
    oc = np.asarray(oracle_cost_arr, np.float64)
    two = (ec == 2.0) | (oc == 2.0)
    mismatch = int(np.sum(two & (np.abs(ec - oc) >= 1e-5)))
    live = ~two
    worst = float(np.max(np.abs(ec - oc)[live])) if live.any() else 0.0
    return worst, int(two.sum()), mismatch
