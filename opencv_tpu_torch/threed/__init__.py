from .pointcloud import (  # noqa: F401
    loadPointCloud, savePointCloud, loadMesh, saveMesh,
)
from .depth import (  # noqa: F401
    depthTo3d, depthTo3dSparse, rescaleDepth, registerDepth, warpFrame,
)
from .rasterize import (  # noqa: F401
    triangleRasterize, triangleRasterizeColor, triangleRasterizeDepth,
    TriangleRasterizeSettings,
    RASTERIZE_CULLING_NONE, RASTERIZE_CULLING_CW, RASTERIZE_CULLING_CCW,
    RASTERIZE_SHADING_WHITE, RASTERIZE_SHADING_FLAT,
    RASTERIZE_SHADING_SHADED,
    RASTERIZE_COMPAT_DISABLED, RASTERIZE_COMPAT_INVDEPTH,
)
