"""cv2.data — bundled trained-model data paths (cv2/data in the wheel).

`haarcascades` resolves to the first available cascade directory:
an in-repo data dir or the installed cv2 wheel's (the cascade XMLs are
interchangeable trained-model data).  Twin of ``opencv_tpu/data``, without
its last candidate, a fixed path outside the repo: where neither holds a
cascade, the in-repo dir is named, as the JAX package names it then.
"""

import os as _os

_here = _os.path.dirname(_os.path.abspath(__file__))
_candidates = [
    _os.path.join(_here, "haarcascades"),
]
try:  # the installed wheel's data dir, when present
    import importlib.util as _ilu
    _spec = _ilu.find_spec("cv2")
    if _spec and _spec.submodule_search_locations:
        for _loc in _spec.submodule_search_locations:
            _candidates.append(_os.path.join(_loc, "data"))
except Exception:
    pass

def _has_cascades(p):
    try:
        return any(f.startswith("haarcascade")
                   for f in _os.listdir(p))
    except OSError:
        return False


haarcascades = next(
    (p + _os.sep for p in _candidates if _has_cascades(p)),
    _candidates[0] + _os.sep)
