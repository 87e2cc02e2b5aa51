"""cv2.typing — type aliases for the Python bindings
(cv2/typing/__init__.py in the wheel).  Aliases are documentation-level
types; numeric tuples/arrays are accepted everywhere."""

import typing as _t

import numpy as _np

NumPyArrayNumeric = _np.ndarray
NumPyArrayFloat32 = _np.ndarray
NumPyArrayFloat64 = _np.ndarray
IntPointer = int
MatLike = _np.ndarray
MatShape = _t.Sequence[int]
Matx33f = _np.ndarray
Matx33d = _np.ndarray
Matx44f = _np.ndarray
Matx44d = _np.ndarray
Vec2i = _t.Tuple[int, int]
Vec2f = _t.Tuple[float, float]
Vec2d = _t.Tuple[float, float]
Vec3i = _t.Tuple[int, int, int]
Vec3f = _t.Tuple[float, float, float]
Vec3d = _t.Tuple[float, float, float]
Vec4i = _t.Tuple[int, int, int, int]
Vec4f = _t.Tuple[float, float, float, float]
Vec4d = _t.Tuple[float, float, float, float]
Vec6f = _t.Tuple[float, float, float, float, float, float]
Point = _t.Tuple[int, int]
Point2i = Point
Point2f = _t.Tuple[float, float]
Point2d = _t.Tuple[float, float]
Point3i = _t.Tuple[int, int, int]
Point3f = _t.Tuple[float, float, float]
Point3d = _t.Tuple[float, float, float]
Size = _t.Tuple[int, int]
Size2f = _t.Tuple[float, float]
Rect = _t.Tuple[int, int, int, int]
Rect2i = Rect
Rect2f = _t.Tuple[float, float, float, float]
Rect2d = _t.Tuple[float, float, float, float]
Range = _t.Tuple[int, int]
Scalar = _t.Sequence[float]
TermCriteria = _t.Tuple[int, int, float]
RotatedRect = _t.Tuple[_t.Tuple[float, float],
                       _t.Tuple[float, float], float]
Moments = _t.Dict[str, float]
IndexParams = _t.Dict[str, _t.Any]
SearchParams = _t.Dict[str, _t.Any]
LayerId = _t.Any
LayerParams = _t.Dict[str, _t.Any]
map_string_and_string = _t.Dict[str, str]
map_string_and_int = _t.Dict[str, int]
map_string_and_vector_size_t = _t.Dict[str, _t.Sequence[int]]
map_string_and_vector_float = _t.Dict[str, _t.Sequence[float]]
map_int_and_double = _t.Dict[int, float]


class TermCriteria_Type:
    COUNT = 1
    MAX_ITER = 1
    EPS = 2


class FeatureDetector:
    pass


class DescriptorExtractor:
    pass


class FeatureExtractor:
    pass
