"""PnP solver family (calib3d/src/epnp.cpp, p3p.cpp, ap3p.cpp,
ippe.cpp, sqpnp.cpp).

All solvers work on normalized (undistorted) image coordinates and
return candidate (R, t) poses; `solvePnP` in [[geometry]] dispatches on
the SOLVEPNP_* flag and picks the minimum-reprojection candidate, like
the reference's solvePnPGeneric.  These are tiny-N host linear-algebra
problems (4-50 points), so they run as numpy — the dense undistortion
ahead of them is the device path.  Twin of ``opencv_tpu/calib3d/pnp.py``:
the same numpy.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["solve_epnp", "solve_p3p", "solve_ippe", "solve_sqpnp"]


def _procrustes(A, B):
    """Rigid transform B ≈ R A + t (Horn): A,B (n,3)."""
    ca = A.mean(0)
    cb = B.mean(0)
    H = (A - ca).T @ (B - cb)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    t = cb - R @ ca
    return R, t


# ---------------------------------------------------------------- EPnP

def solve_epnp(obj, und):
    """EPnP (Lepetit et al. IJCV'09; epnp.cpp): 4 control points,
    barycentric coordinates, null-space betas for N=1..3 with
    Gauss-Newton refinement on control-point distances."""
    n = len(obj)
    c0 = obj.mean(0)
    A = obj - c0
    cov = A.T @ A / n
    w, v = np.linalg.eigh(cov)           # ascending
    # control points along principal directions
    ctrl = [c0]
    for k in range(3):
        ctrl.append(c0 + math.sqrt(max(w[2 - k], 0)) * v[:, 2 - k])
    C = np.asarray(ctrl)                  # (4,3)
    # barycentric coordinates
    CC = np.vstack([C.T, np.ones(4)])     # 4x4
    alphas = np.linalg.solve(CC, np.vstack([obj.T, np.ones(n)])).T  # (n,4)

    # normalized camera: fu=fv=1, uc=vc=0
    M = np.zeros((2 * n, 12))
    for i in range(n):
        for j in range(4):
            a = alphas[i, j]
            M[2 * i, 3 * j] = a
            M[2 * i, 3 * j + 2] = -a * und[i, 0]
            M[2 * i + 1, 3 * j + 1] = a
            M[2 * i + 1, 3 * j + 2] = -a * und[i, 1]
    MtM = M.T @ M
    _, V = np.linalg.eigh(MtM)
    Vs = V[:, :4]                         # 4 smallest, ascending

    dist_pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    rho = np.asarray([np.sum((C[a] - C[b]) ** 2) for a, b in dist_pairs])

    def L_matrix(cols):
        """Rows of ||dv_a - dv_b||² cross terms for betas products."""
        vs = [Vs[:, c].reshape(4, 3) for c in cols]
        dv = [np.asarray([vv[a] - vv[b] for a, b in dist_pairs])
              for vv in vs]
        return dv

    def pose_from_betas(betas, cols):
        x = sum(b * Vs[:, c] for b, c in zip(betas, cols))
        cc = x.reshape(4, 3)
        # enforce positive depth (cheirality on control points)
        pts_c = alphas @ cc
        if np.sum(pts_c[:, 2] < 0) > n / 2:
            cc = -cc
            pts_c = -pts_c
        R, t = _procrustes(C, cc)
        return R, t

    def reproj_err(R, t):
        pc = obj @ R.T + t
        with np.errstate(divide="ignore", invalid="ignore"):
            p = pc[:, :2] / pc[:, 2:3]
        return float(np.nansum((p - und) ** 2))

    candidates = []
    # N=1
    v0 = Vs[:, 0].reshape(4, 3)
    dv0 = np.asarray([v0[a] - v0[b] for a, b in dist_pairs])
    denom = np.sum(dv0 * dv0, axis=1)
    beta1 = math.sqrt(max(float(np.sum(denom * rho))
                          / max(float(np.sum(denom * denom)), 1e-12), 0))
    candidates.append(([beta1], [0]))
    # N=2: unknowns b0², b0b1, b1² over columns (0,1)
    dvs = L_matrix([0, 1])
    L = np.column_stack([
        np.sum(dvs[0] * dvs[0], 1),
        2 * np.sum(dvs[0] * dvs[1], 1),
        np.sum(dvs[1] * dvs[1], 1)])
    sol, *_ = np.linalg.lstsq(L, rho, rcond=None)
    b0 = math.sqrt(abs(sol[0]))
    b1 = math.sqrt(abs(sol[2])) * (1 if sol[1] >= 0 else -1)
    candidates.append(([b0, b1], [0, 1]))
    # N=3
    dvs = L_matrix([0, 1, 2])
    L = np.column_stack([
        np.sum(dvs[0] * dvs[0], 1),
        2 * np.sum(dvs[0] * dvs[1], 1),
        np.sum(dvs[1] * dvs[1], 1),
        2 * np.sum(dvs[0] * dvs[2], 1),
        2 * np.sum(dvs[1] * dvs[2], 1),
        np.sum(dvs[2] * dvs[2], 1)])
    sol, *_ = np.linalg.lstsq(L, rho, rcond=None)
    b0 = math.sqrt(abs(sol[0]))
    b1 = math.sqrt(abs(sol[2])) * (1 if sol[1] >= 0 else -1)
    b2 = math.sqrt(abs(sol[5])) * (1 if sol[3] >= 0 else -1)
    candidates.append(([b0, b1, b2], [0, 1, 2]))

    best = None
    for betas, cols in candidates:
        # Gauss-Newton refinement of betas on control distances
        betas = np.asarray(betas, np.float64)
        dvs = L_matrix(cols)
        for _ in range(5):
            cc = sum(b * Vs[:, c] for b, c in zip(betas, cols))
            cc = cc.reshape(4, 3)
            d = np.asarray([np.sum((cc[a] - cc[b]) ** 2)
                            for a, b in dist_pairs])
            J = np.zeros((6, len(betas)))
            for k in range(len(betas)):
                diffs = np.asarray([cc[a] - cc[b]
                                    for a, b in dist_pairs])
                J[:, k] = 2 * np.sum(diffs * dvs[k], axis=1)
            try:
                step, *_ = np.linalg.lstsq(J, rho - d, rcond=None)
            except np.linalg.LinAlgError:
                break
            betas = betas + step
        R, t = pose_from_betas(betas, cols)
        e = reproj_err(R, t)
        if best is None or e < best[0]:
            best = (e, R, t)
    return [(best[1], best[2])]


# ----------------------------------------------------------------- P3P

def solve_p3p(obj, und):
    """P3P on the first three points (Grunert quartic, the classical
    system p3p.cpp solves), up to 4 (R, t) candidates."""
    P = obj[:3]
    f = np.column_stack([und[:3], np.ones(3)])
    f = f / np.linalg.norm(f, axis=1, keepdims=True)
    # pairwise data
    cos_ab = f[0] @ f[1]
    cos_ac = f[0] @ f[2]
    cos_bc = f[1] @ f[2]
    Rab2 = np.sum((P[0] - P[1]) ** 2)
    Rac2 = np.sum((P[0] - P[2]) ** 2)
    Rbc2 = np.sum((P[1] - P[2]) ** 2)
    if min(Rab2, Rac2, Rbc2) < 1e-16:
        return []
    K1 = Rbc2 / Rac2
    K2 = Rbc2 / Rab2
    # Grunert: quartic in x = d2/d1
    G4 = (K1 * K2 - K1 - K2) ** 2 - 4 * K1 * K2 * cos_bc ** 2
    G3 = (4 * (K1 * K2 - K1 - K2) * K2 * (1 - K1) * cos_ab
          + 4 * K1 * cos_bc * ((K1 * K2 - K1 + K2) * cos_ac
                               + 2 * K2 * cos_ab * cos_bc))
    G2 = ((2 * K2 * (1 - K1) * cos_ab) ** 2
          + 2 * (K1 * K2 - K1 - K2) * (K1 * K2 + K1 - K2)
          + 4 * K1 * ((K1 - K2) * cos_bc ** 2
                      + K1 * (1 - K2) * cos_ac ** 2
                      - 2 * (1 + K1) * K2 * cos_ab * cos_ac * cos_bc))
    G1 = (4 * (K1 * K2 + K1 - K2) * K2 * (1 - K1) * cos_ab
          + 4 * K1 * ((K1 * K2 - K1 + K2) * cos_ac * cos_bc
                      + 2 * K1 * K2 * cos_ab * cos_ac ** 2))
    G0 = (K1 * K2 + K1 - K2) ** 2 - 4 * K1 ** 2 * K2 * cos_ac ** 2
    roots = np.roots([G4, G3, G2, G1, G0])
    out = []
    for x in roots:
        if abs(x.imag) > 1e-8 or x.real <= 0:
            continue
        x = float(x.real)
        # d1 from the ab equation
        den = x * x - 2 * x * cos_ab + 1
        if den <= 1e-16:
            continue
        d1 = math.sqrt(Rab2 / den)
        d2 = x * d1
        # y = d3/d1 from one of the quadratics
        m = 1 - K1
        pq = 2 * (K1 * cos_ac - x * cos_bc)
        q = x * x - K1
        m1 = 1.0
        p1 = 2 * (-x * cos_bc)
        q1 = x * x * (1 - K2) + 2 * x * K2 * cos_ab - K2
        if abs(m1 * q - m * q1) < 1e-16:
            # degenerate: solve quadratic y² - 2 y cos_ac + 1 - Rac²/d1² = 0
            disc = cos_ac ** 2 - 1 + Rac2 / (d1 * d1)
            if disc < 0:
                continue
            ys = [cos_ac + math.sqrt(disc), cos_ac - math.sqrt(disc)]
        else:
            ys = [(p1 * q - p1 * q1 * 0 - (pq * q1 - pq * 0)) /
                  (m1 * q - m * q1) if False else
                  (pq * q1 - p1 * q) / (m1 * q - m * q1)]
        for y in ys:
            if y <= 0:
                continue
            d3 = y * d1
            # camera-frame points
            pc = np.asarray([d1 * f[0], d2 * f[1], d3 * f[2]])
            R, t = _procrustes(P, pc)
            out.append((R, t))
    return out


# ---------------------------------------------------------------- IPPE

def solve_ippe(obj, und):
    """Planar pose with the IPPE two-fold ambiguity (ippe.cpp role):
    the primary pose from the exact homography decomposition
    H ~ [r1 r2 t], and the mirrored candidate (the planar pose
    ambiguity) with its translation re-estimated by least squares.
    The dispatcher keeps the lower-reprojection one, matching the
    reference's returned best solution."""
    from .geometry import findHomography
    if np.ptp(obj[:, 2]) > 1e-9:
        return []
    op = obj[:, :2]
    H, _ = findHomography(op, und)
    if H is None:
        return []
    h1 = H[:, 0]
    h2 = H[:, 1]
    h3 = H[:, 2]
    lam = 2.0 / max(np.linalg.norm(h1) + np.linalg.norm(h2), 1e-12)
    r1 = h1 * lam
    r2 = h2 * lam
    t = h3 * lam
    if t[2] < 0:
        r1, r2, t = -r1, -r2, -t
    r3 = np.cross(r1, r2)
    Rm = np.column_stack([r1, r2, r3])
    U, _, Vt = np.linalg.svd(Rm)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R1 = U @ D @ Vt

    def lls_t(R):
        n = len(op)
        P3 = np.column_stack([op, np.zeros(n)])
        rp = P3 @ R.T
        Am = np.zeros((2 * n, 3))
        bm = np.zeros(2 * n)
        Am[0::2, 0] = 1
        Am[0::2, 2] = -und[:, 0]
        Am[1::2, 1] = 1
        Am[1::2, 2] = -und[:, 1]
        bm[0::2] = und[:, 0] * rp[:, 2] - rp[:, 0]
        bm[1::2] = und[:, 1] * rp[:, 2] - rp[:, 1]
        tt, *_ = np.linalg.lstsq(Am, bm, rcond=None)
        return tt

    t1 = lls_t(R1)
    Dm = np.diag([1.0, 1.0, -1.0])
    R2 = Dm @ R1 @ Dm
    t2 = lls_t(R2)
    return [(R1, t1), (R2, t2)]


# --------------------------------------------------------------- SQPnP

def solve_sqpnp(obj, und):
    """SQPnP (Terzakis & Lourakis ECCV'20; sqpnp.cpp): global
    minimization of r^T Omega r over SO(3), here by eigenvector
    initialization + manifold Gauss-Newton from several starts."""
    n = len(obj)
    # t elimination: for each point, A_i r + B_i t = 0 structure
    # with projection constraints; build Omega (9x9)
    # rows: x*Z - X = 0 -> using u = x: [P 0 -uP] r + [1 0 -u] t
    A = np.zeros((2 * n, 9))
    B = np.zeros((2 * n, 3))
    for i in range(n):
        X = obj[i]
        u, v = und[i]
        A[2 * i, 0:3] = X
        A[2 * i, 6:9] = -u * X
        B[2 * i] = [1, 0, -u]
        A[2 * i + 1, 3:6] = X
        A[2 * i + 1, 6:9] = -v * X
        B[2 * i + 1] = [0, 1, -v]
    # t = -(B^T B)^-1 B^T A r
    BtB = B.T @ B
    BtA = B.T @ A
    P = -np.linalg.solve(BtB, BtA)
    M = A + B @ P
    Omega = M.T @ M

    w, V = np.linalg.eigh(Omega)

    def nearest_rot(r9):
        R = r9.reshape(3, 3)
        U, _, Vt = np.linalg.svd(R)
        D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        return (U @ D @ Vt)

    def refine(R):
        """Manifold Gauss-Newton on min r^T Omega r."""
        for _ in range(20):
            r = R.reshape(9)
            # gradient in tangent space: dR = R [w]_x
            Jt = np.zeros((9, 3))
            gen = [np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]]),
                   np.array([[0, 0, 1], [0, 0, 0], [-1, 0, 0]]),
                   np.array([[0, -1, 0], [1, 0, 0], [0, 0, 0]])]
            for k in range(3):
                Jt[:, k] = (R @ gen[k]).reshape(9)
            g = 2 * Jt.T @ (Omega @ r)
            Hm = 2 * Jt.T @ Omega @ Jt
            try:
                step = np.linalg.solve(Hm + 1e-12 * np.eye(3), -g)
            except np.linalg.LinAlgError:
                break
            if np.linalg.norm(step) < 1e-14:
                break
            th = np.linalg.norm(step)
            k = step / max(th, 1e-300)
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                           [-k[1], k[0], 0]])
            dR = (np.eye(3) + math.sin(th) * Kx
                  + (1 - math.cos(th)) * Kx @ Kx)
            R = R @ dR
        return R

    out = []
    seen = []
    for k in range(3):   # three smallest eigenvectors as starts
        # eigenvectors carry a sign ambiguity: project BOTH ±v onto
        # SO(3) (the projections differ; negating a 3x3 flips det)
        for Rs in (nearest_rot(V[:, k]), nearest_rot(-V[:, k])):
            R = refine(Rs)
            t = P @ R.reshape(9)
            # cheirality
            pc = obj @ R.T + t
            if np.mean(pc[:, 2] > 0) < 0.5:
                continue
            dup = any(np.abs(R - Rp).max() < 1e-6 for Rp, _ in seen)
            if not dup:
                seen.append((R, t))
                out.append((R, t))
    return out
