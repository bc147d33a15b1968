// Fast COLMAP binary parsers (points3D.bin / images.bin).
//
// Native counterpart of crates/colmap-reader (the reference's standalone
// Rust parser): the hot loops — millions of variable-length point/track
// records — run far faster here than record-at-a-time Python struct
// unpacking. Exposed as a CPython extension module (brush_tpu's parser,
// as the PyTorch port's own); brush_tpu_torch.data.colmap reads with the
// pure-Python parser when the extension isn't built.
//
// Build: python -m brush_tpu_torch.native.build  (g++ -O2 -shared -fPIC)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T read() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  bool skip(size_t n) {
    if (p + n > end) {
      ok = false;
      return false;
    }
    p += n;
    return true;
  }
};

// points3D.bin: u64 count, then per point:
//   u64 id, 3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len,
//   track_len x (i32 image_id, i32 point2d_idx)
PyObject* parse_points3d(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  Cursor c{static_cast<const uint8_t*>(buf.buf),
           static_cast<const uint8_t*>(buf.buf) + buf.len};

  uint64_t n = c.read<uint64_t>();
  std::vector<double> xyz;
  std::vector<uint8_t> rgb;
  xyz.reserve(n * 3);
  rgb.reserve(n * 3);

  for (uint64_t i = 0; i < n && c.ok; i++) {
    c.skip(8);  // id
    for (int k = 0; k < 3; k++) xyz.push_back(c.read<double>());
    for (int k = 0; k < 3; k++) rgb.push_back(c.read<uint8_t>());
    c.skip(8);  // error
    uint64_t track = c.read<uint64_t>();
    c.skip(track * 8);
  }
  PyBuffer_Release(&buf);
  if (!c.ok) {
    PyErr_SetString(PyExc_ValueError, "truncated points3D.bin");
    return nullptr;
  }

  PyObject* xyz_b =
      PyBytes_FromStringAndSize(reinterpret_cast<const char*>(xyz.data()),
                                static_cast<Py_ssize_t>(xyz.size() * 8));
  PyObject* rgb_b =
      PyBytes_FromStringAndSize(reinterpret_cast<const char*>(rgb.data()),
                                static_cast<Py_ssize_t>(rgb.size()));
  PyObject* out = Py_BuildValue("(KNN)", (unsigned long long)(xyz.size() / 3),
                                xyz_b, rgb_b);
  return out;
}

// images.bin: u64 count, then per image:
//   i32 id, 4x f64 qvec, 3x f64 tvec, i32 camera_id, cstr name,
//   u64 n2d, n2d x (f64 x, f64 y, i64 p3d_id)
PyObject* parse_images(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  Cursor c{static_cast<const uint8_t*>(buf.buf),
           static_cast<const uint8_t*>(buf.buf) + buf.len};

  uint64_t n = c.read<uint64_t>();
  PyObject* list = PyList_New(0);

  for (uint64_t i = 0; i < n && c.ok; i++) {
    int32_t img_id = c.read<int32_t>();
    double q[4], t[3];
    for (double& v : q) v = c.read<double>();
    for (double& v : t) v = c.read<double>();
    int32_t cam_id = c.read<int32_t>();
    std::string name;
    while (c.p < c.end) {
      char ch = static_cast<char>(c.read<uint8_t>());
      if (ch == '\0') break;
      name.push_back(ch);
    }
    uint64_t n2d = c.read<uint64_t>();
    c.skip(n2d * 24);
    if (!c.ok) break;

    PyObject* rec = Py_BuildValue(
        "(i(dddd)(ddd)is)", img_id, q[0], q[1], q[2], q[3], t[0], t[1], t[2],
        cam_id, name.c_str());
    PyList_Append(list, rec);
    Py_DECREF(rec);
  }
  PyBuffer_Release(&buf);
  if (!c.ok) {
    Py_DECREF(list);
    PyErr_SetString(PyExc_ValueError, "truncated images.bin");
    return nullptr;
  }
  return list;
}

PyMethodDef methods[] = {
    {"parse_points3d", parse_points3d, METH_VARARGS,
     "points3D.bin bytes -> (n, xyz f64 bytes, rgb u8 bytes)"},
    {"parse_images", parse_images, METH_VARARGS,
     "images.bin bytes -> list of (id, qvec, tvec, camera_id, name)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_colmapio",
                      "Fast COLMAP binary parsers", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__colmapio(void) { return PyModule_Create(&module); }
