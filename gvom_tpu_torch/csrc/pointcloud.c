/* Native PointCloud2 xyz extraction.
 *
 * Strided field extraction + NaN compaction in one pass — the host-side
 * deserialize the reference does in Python via ros_numpy
 * (gvom_ros.py:108). Built as a shared library and loaded via ctypes
 * (no pybind11 dependency); see gvom_tpu_torch/io/pointcloud2.py.
 * A host helper, not a GPU kernel: built with cc into gvom_tpu_torch/_build.
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

/* datatype codes per sensor_msgs/PointField */
#define PF_FLOAT32 7
#define PF_FLOAT64 8

long extract_xyz_f32(
    const char *data,
    long n_points,
    long point_step,
    long off_x,
    long off_y,
    long off_z,
    int datatype,
    int drop_nan,
    float *out /* [n_points * 3] */)
{
    long kept = 0;
    if (datatype == PF_FLOAT32) {
        for (long i = 0; i < n_points; ++i) {
            const char *p = data + i * point_step;
            float x, y, z;
            memcpy(&x, p + off_x, sizeof(float));
            memcpy(&y, p + off_y, sizeof(float));
            memcpy(&z, p + off_z, sizeof(float));
            if (drop_nan && !(isfinite(x) && isfinite(y) && isfinite(z)))
                continue;
            out[kept * 3 + 0] = x;
            out[kept * 3 + 1] = y;
            out[kept * 3 + 2] = z;
            ++kept;
        }
    } else if (datatype == PF_FLOAT64) {
        for (long i = 0; i < n_points; ++i) {
            const char *p = data + i * point_step;
            double x, y, z;
            memcpy(&x, p + off_x, sizeof(double));
            memcpy(&y, p + off_y, sizeof(double));
            memcpy(&z, p + off_z, sizeof(double));
            if (drop_nan && !(isfinite(x) && isfinite(y) && isfinite(z)))
                continue;
            out[kept * 3 + 0] = (float)x;
            out[kept * 3 + 1] = (float)y;
            out[kept * 3 + 2] = (float)z;
            ++kept;
        }
    } else {
        return -1;
    }
    return kept;
}
