"""Hand-eye and robot-world/hand-eye calibration
(`cv2.calibrateHandEye` / `cv2.calibrateRobotWorldHandEye`,
modules/calib3d/src/calibration_handeye.cpp).

Five AX=XB solvers (Tsai, Park, Horaud, Andreff, Daniilidis) and two
AX=ZB solvers (Shah, Li) — all classical closed-form/linear methods on
small matrices, a pure host tier (the per-pose transforms are 4x4).
Twin of ``opencv_tpu/calib3d/handeye.py``: the same numpy.
"""

from __future__ import annotations

import numpy as np

from .. import constants as K

__all__ = ["calibrateHandEye", "calibrateRobotWorldHandEye"]

CALIB_HAND_EYE_TSAI = 0
CALIB_HAND_EYE_PARK = 1
CALIB_HAND_EYE_HORAUD = 2
CALIB_HAND_EYE_ANDREFF = 3
CALIB_HAND_EYE_DANIILIDIS = 4

CALIB_ROBOT_WORLD_HAND_EYE_SHAH = 0
CALIB_ROBOT_WORLD_HAND_EYE_LI = 1


def _to_R(r):
    r = np.asarray(r, np.float64)
    if r.shape[-2:] == (3, 3):
        return r.reshape(3, 3)
    from .geometry import Rodrigues
    return np.asarray(Rodrigues(r.reshape(3, 1))[0])


def _homog(R, t):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t, np.float64).reshape(3)
    return T


def _log_rot(R):
    """SO(3) log map → 3-vector."""
    tr = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                  R[1, 0] - R[0, 1]])
    return theta / (2 * np.sin(theta)) * w


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                     [-v[1], v[0], 0]], np.float64)


def _quat_from_R(R):
    """Unit quaternion (w, x, y, z)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _R_from_quat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _motion_pairs(R_g2b, t_g2b, R_t2c, t_t2c):
    """Relative motions A_i (gripper) and B_i (camera) for AX = XB."""
    n = len(R_g2b)
    Hg = [_homog(_to_R(R_g2b[i]), t_g2b[i]) for i in range(n)]
    Hc = [_homog(_to_R(R_t2c[i]), t_t2c[i]) for i in range(n)]
    As, Bs = [], []
    for i in range(n):
        for j in range(i + 1, n):
            As.append(np.linalg.inv(Hg[j]) @ Hg[i])
            Bs.append(Hc[j] @ np.linalg.inv(Hc[i]))
    return As, Bs


def _solve_translation(As, Bs, Rx):
    """(R_A - I) t_X = R_X t_B - t_A least squares."""
    M = []
    b = []
    for A, B in zip(As, Bs):
        M.append(A[:3, :3] - np.eye(3))
        b.append(Rx @ B[:3, 3] - A[:3, 3])
    M = np.concatenate(M, axis=0)
    b = np.concatenate(b, axis=0)
    t, *_ = np.linalg.lstsq(M, b, rcond=None)
    return t


def _he_tsai(As, Bs):
    """Tsai-Lenz: modified Rodrigues vectors P = 2 sin(θ/2) n."""
    M, b = [], []
    for A, B in zip(As, Bs):
        ra = _log_rot(A[:3, :3])
        rb = _log_rot(B[:3, :3])
        th_a = np.linalg.norm(ra)
        th_b = np.linalg.norm(rb)
        Pa = (2 * np.sin(th_a / 2) * ra / th_a) if th_a > 1e-12 \
            else np.zeros(3)
        Pb = (2 * np.sin(th_b / 2) * rb / th_b) if th_b > 1e-12 \
            else np.zeros(3)
        M.append(_skew(Pa + Pb))
        b.append(Pb - Pa)
    M = np.concatenate(M, axis=0)
    b = np.concatenate(b, axis=0)
    p, *_ = np.linalg.lstsq(M, b, rcond=None)
    pn = 2 * p / np.sqrt(1 + p @ p)
    n2 = pn @ pn
    Rx = (1 - n2 / 2) * np.eye(3) + 0.5 * (
        np.outer(pn, pn) + np.sqrt(max(4 - n2, 0)) * _skew(pn))
    return Rx, _solve_translation(As, Bs, Rx)


def _he_park(As, Bs):
    """Park-Martin: M = Σ β αᵀ, R = (MᵀM)^(-1/2) Mᵀ."""
    M = np.zeros((3, 3))
    for A, B in zip(As, Bs):
        a = _log_rot(A[:3, :3])
        b = _log_rot(B[:3, :3])
        M += np.outer(b, a)
    u, s, vt = np.linalg.svd(M.T @ M)
    inv_sqrt = u @ np.diag(1.0 / np.sqrt(s)) @ vt
    Rx = inv_sqrt @ M.T
    return Rx, _solve_translation(As, Bs, Rx)


def _he_horaud(As, Bs):
    """Horaud-Dornaika: quaternion eigen-solution."""
    S = np.zeros((4, 4))
    for A, B in zip(As, Bs):
        qa = _quat_from_R(A[:3, :3])
        qb = _quat_from_R(B[:3, :3])

        def lmat(q):
            w, v = q[0], q[1:]
            m = np.zeros((4, 4))
            m[0, 0] = w
            m[0, 1:] = -v
            m[1:, 0] = v
            m[1:, 1:] = w * np.eye(3) + _skew(v)
            return m

        def rmat(q):
            w, v = q[0], q[1:]
            m = np.zeros((4, 4))
            m[0, 0] = w
            m[0, 1:] = -v
            m[1:, 0] = v
            m[1:, 1:] = w * np.eye(3) - _skew(v)
            return m

        D = lmat(qa) - rmat(qb)
        S += D.T @ D
    w, V = np.linalg.eigh(S)
    q = V[:, 0]
    Rx = _R_from_quat(q)
    return Rx, _solve_translation(As, Bs, Rx)


def _he_andreff(As, Bs):
    """Andreff: Kronecker-product linear system for R and t jointly."""
    rows = []
    rhs = []
    I9 = np.eye(9)
    for A, B in zip(As, Bs):
        Ra, Rb = A[:3, :3], B[:3, :3]
        ta, tb = A[:3, 3], B[:3, 3]
        r1 = np.zeros((9, 12))
        r1[:, :9] = I9 - np.kron(Ra, Rb)
        rows.append(r1)
        rhs.append(np.zeros(9))
        r2 = np.zeros((3, 12))
        r2[:, :9] = np.kron(np.eye(3), tb)
        r2[:, 9:] = np.eye(3) - Ra
        rows.append(r2)
        rhs.append(ta)
    Mm = np.concatenate(rows, axis=0)
    bb = np.concatenate(rhs)
    x, *_ = np.linalg.lstsq(Mm, bb, rcond=None)
    Rraw = x[:9].reshape(3, 3)
    # project to SO(3) with scale (Andreff's determinant normalization)
    det = np.linalg.det(Rraw)
    Rn = np.sign(det) * Rraw / abs(det) ** (1 / 3)
    u, _, vt = np.linalg.svd(Rn)
    Rx = u @ vt
    if np.linalg.det(Rx) < 0:
        Rx = u @ np.diag([1, 1, -1]) @ vt
    return Rx, _solve_translation(As, Bs, Rx)


def _he_daniilidis(As, Bs):
    """Daniilidis: dual-quaternion SVD solution."""
    T = []
    for A, B in zip(As, Bs):
        qa = _quat_from_R(A[:3, :3])
        qb = _quat_from_R(B[:3, :3])
        if qa[0] < 0:
            qa = -qa
        if qb[0] < 0:
            qb = -qb
        ta, tb = A[:3, 3], B[:3, 3]
        qta = np.concatenate([[0.0], ta])

        def qmul(p, q):
            w = p[0] * q[0] - p[1:] @ q[1:]
            v = p[0] * q[1:] + q[0] * p[1:] + np.cross(p[1:], q[1:])
            return np.concatenate([[w], v])

        da = 0.5 * qmul(qta, qa)
        qtb = np.concatenate([[0.0], tb])
        db = 0.5 * qmul(qtb, qb)
        a, ap = qa[1:], da[1:]
        b, bp = qb[1:], db[1:]
        a0, ap0 = qa[0], da[0]
        b0, bp0 = qb[0], db[0]
        r = np.zeros((6, 8))
        r[:3, 0] = a - b
        r[:3, 1:4] = _skew(a + b)
        r[3:, 0] = ap - bp
        r[3:, 1:4] = _skew(ap + bp)
        r[3:, 4] = a - b
        r[3:, 5:8] = _skew(a + b)
        T.append(r)
    T = np.concatenate(T, axis=0)
    _, s, vt = np.linalg.svd(T)
    v7 = vt[6]
    v8 = vt[7]
    u1, v1 = v7[:4], v7[4:]
    u2, v2 = v8[:4], v8[4:]
    # solve λ1 u1 + λ2 u2 unit, orthogonality constraint
    a = u1 @ v1
    b = u1 @ v2 + u2 @ v1
    c = u2 @ v2
    if abs(a) < 1e-12:
        s_ = 0.0 if abs(b) < 1e-12 else -c / b
        sols = [s_]
    else:
        disc = b * b - 4 * a * c
        disc = max(disc, 0.0)
        sols = [(-b + np.sqrt(disc)) / (2 * a),
                (-b - np.sqrt(disc)) / (2 * a)]
    # pick the root maximizing s²u1·u1 + 2s u1·u2 + u2·u2 (Daniilidis:
    # the larger real-part norm gives the valid unit dual quaternion)
    best = None
    for s_ in sols:
        val = s_ * s_ * (u1 @ u1) + 2 * s_ * (u1 @ u2) + (u2 @ u2)
        if val <= 0:
            continue
        if best is None or val > best[0]:
            best = (val, s_)
    val, s_ = best
    l2 = np.sqrt(1.0 / val)
    l1 = s_ * l2
    q = l1 * u1 + l2 * u2
    qp = l1 * v1 + l2 * v2
    Rx = _R_from_quat(q)

    def qmul(p, r):
        w = p[0] * r[0] - p[1:] @ r[1:]
        v = p[0] * r[1:] + r[0] * p[1:] + np.cross(p[1:], r[1:])
        return np.concatenate([[w], v])

    qc = np.concatenate([[q[0]], -q[1:]])
    t = 2 * qmul(qp, qc)[1:]
    return Rx, t


_HE_METHODS = {
    CALIB_HAND_EYE_TSAI: _he_tsai,
    CALIB_HAND_EYE_PARK: _he_park,
    CALIB_HAND_EYE_HORAUD: _he_horaud,
    CALIB_HAND_EYE_ANDREFF: _he_andreff,
    CALIB_HAND_EYE_DANIILIDIS: _he_daniilidis,
}


def calibrateHandEye(R_gripper2base, t_gripper2base, R_target2cam,
                     t_target2cam, method: int = CALIB_HAND_EYE_TSAI):
    """Returns (R_cam2gripper, t_cam2gripper) solving AX = XB
    (calibration_handeye.cpp:calibrateHandEye)."""
    As, Bs = _motion_pairs(R_gripper2base, t_gripper2base,
                           R_target2cam, t_target2cam)
    Rx, tx = _HE_METHODS[method](As, Bs)
    return Rx, tx.reshape(3, 1)


def calibrateRobotWorldHandEye(R_world2cam, t_world2cam, R_base2gripper,
                               t_base2gripper,
                               method: int = CALIB_ROBOT_WORLD_HAND_EYE_SHAH):
    """Solves AX = ZB: A = world2cam, B = base2gripper;
    X = base2world, Z = gripper2cam (calibration_handeye.cpp)."""
    n = len(R_world2cam)
    A = [_homog(_to_R(R_world2cam[i]), t_world2cam[i]) for i in range(n)]
    B = [_homog(_to_R(R_base2gripper[i]), t_base2gripper[i])
         for i in range(n)]

    if method == CALIB_ROBOT_WORLD_HAND_EYE_LI:
        # Li: single linear system via Kronecker products
        rows, rhs = [], []
        for Ai, Bi in zip(A, B):
            Ra, Rb = Ai[:3, :3], Bi[:3, :3]
            ta, tb = Ai[:3, 3], Bi[:3, 3]
            r1 = np.zeros((9, 24))
            r1[:, :9] = np.kron(Ra, np.eye(3))
            r1[:, 9:18] = -np.kron(np.eye(3), Rb.T)
            rows.append(r1)
            rhs.append(np.zeros(9))
            r2 = np.zeros((3, 24))
            r2[:, 9:18] = np.kron(np.eye(3), tb.T)
            r2[:, 18:21] = -Ra
            r2[:, 21:24] = np.eye(3)
            rows.append(r2)
            rhs.append(ta)
        M = np.concatenate(rows, axis=0)
        bb = np.concatenate(rhs)
        x, *_ = np.linalg.lstsq(M, bb, rcond=None)

        def proj(m9):
            Rr = m9.reshape(3, 3)
            u, _, vt = np.linalg.svd(Rr)
            R = u @ vt
            if np.linalg.det(R) < 0:
                R = u @ np.diag([1, 1, -1]) @ vt
            return R
        Rx = proj(x[:9])          # base2world (X)
        Rz = proj(x[9:18])        # gripper2cam (Z)
        tx = x[18:21]
        tz = x[21:24]
        return Rx, tx.reshape(3, 1), Rz, tz.reshape(3, 1)

    # Shah: separable — rotation via Kronecker SVD, translation LS
    Kk = np.zeros((9, 9))
    for Ai, Bi in zip(A, B):
        Kk += np.kron(Bi[:3, :3], Ai[:3, :3])
    u, s, vt = np.linalg.svd(Kk)
    # rank-1 factors: vec(Rx'?) — the dominant singular vectors factor
    x1 = u[:, 0].reshape(3, 3)
    y1 = vt[0].reshape(3, 3)

    def proj_scaled(m):
        det = np.linalg.det(m)
        mn = np.sign(det) * m / abs(det) ** (1 / 3)
        uu, _, vv = np.linalg.svd(mn)
        R = uu @ vv
        if np.linalg.det(R) < 0:
            R = uu @ np.diag([1, 1, -1]) @ vv
        return R
    # vec() factor orientation: kron(Rb, Ra) vec(Rz) = vec(Rx...)
    Rz = proj_scaled(x1.T)   # gripper2cam
    Rx = proj_scaled(y1.T)   # base2world
    # translation: Ra tx + ta = Rz tb + tz... A X = Z B:
    # Ra tx - tz = Rz tb - ta  (solve for tx, tz jointly)
    rows, rhs = [], []
    for Ai, Bi in zip(A, B):
        r = np.zeros((3, 6))
        r[:, :3] = Ai[:3, :3]
        r[:, 3:] = -np.eye(3)
        rows.append(r)
        rhs.append(Rz @ Bi[:3, 3] - Ai[:3, 3])
    M = np.concatenate(rows, axis=0)
    bb = np.concatenate(rhs)
    sol, *_ = np.linalg.lstsq(M, bb, rcond=None)
    return Rx, sol[:3].reshape(3, 1), Rz, sol[3:].reshape(3, 1)