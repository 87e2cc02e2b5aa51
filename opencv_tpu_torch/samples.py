"""cv2.samples — sample-data file resolution (core/src/utils/samples.cpp)."""

import os

_search_paths = []
_sub_dirs = [""]


def addSamplesDataSearchPath(path):
    _search_paths.insert(0, str(path))


def addSamplesDataSearchSubDirectory(subdir):
    _sub_dirs.insert(0, str(subdir))


def findFile(relative_path, required=True, silentMode=False):
    rp = str(relative_path)
    if os.path.isabs(rp) and os.path.exists(rp):
        return rp
    roots = list(_search_paths)
    env = os.environ.get("OPENCV_SAMPLES_DATA_PATH")
    if env:
        roots.append(env)
    roots.append(os.getcwd())
    for root in roots:
        for sub in _sub_dirs:
            cand = os.path.join(root, sub, rp) if sub else \
                os.path.join(root, rp)
            if os.path.exists(cand):
                return cand
    if required:
        raise FileNotFoundError(
            f"OpenCV samples: Can't find required data file: {rp}")
    return ""


def findFileOrKeep(relative_path, silentMode=False):
    found = findFile(relative_path, required=False,
                     silentMode=silentMode)
    return found or str(relative_path)
