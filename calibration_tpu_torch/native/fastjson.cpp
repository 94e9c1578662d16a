// Fast JSON serializer for the artifact-writing hot path.
//
// The reference serializes reports/artifacts through nlohmann::json in C++
// (include/calib/io/json.h); the rebuild's pipeline artifacts are plain
// Python dict/list trees whose stdlib json.dumps dominated the full-pipeline
// wall time (5P bench profile: ~0.6s of a 1.3s warm 16-rig run went to
// json.encoder._iterencode + float repr). This module walks the tree in C
// and formats doubles with std::to_chars (shortest round-trip, same value
// semantics as Python's float repr), matching stdlib json.dumps output
// byte-for-byte for the supported types (dict/list/tuple/str/int/float/
// bool/None + numpy scalars via .item()) with ensure_ascii=True and either
// default separators or indent=N.
//
// Unsupported types raise TypeError; the Python wrapper falls back to
// stdlib json so behavior never regresses.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

constexpr int kMaxDepth = 512;

struct Writer {
    std::string out;
    int indent = -1;  // -1: compact (", " / ": "), >=0: indent width

    void pad(int depth) {
        out.push_back('\n');
        out.append(static_cast<size_t>(depth) * indent, ' ');
    }
};

bool encode(Writer& w, PyObject* obj, int depth);

// ensure_ascii escaping, identical table to CPython's json C encoder
void escape_string(Writer& w, const char* s, Py_ssize_t n) {
    w.out.push_back('"');
    const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
    Py_ssize_t i = 0;
    char buf[16];
    while (i < n) {
        unsigned char c = p[i];
        if (c < 0x80) {
            switch (c) {
                case '"': w.out += "\\\""; break;
                case '\\': w.out += "\\\\"; break;
                case '\b': w.out += "\\b"; break;
                case '\f': w.out += "\\f"; break;
                case '\n': w.out += "\\n"; break;
                case '\r': w.out += "\\r"; break;
                case '\t': w.out += "\\t"; break;
                default:
                    if (c < 0x20) {
                        std::snprintf(buf, sizeof buf, "\\u%04x", c);
                        w.out += buf;
                    } else {
                        w.out.push_back(static_cast<char>(c));
                    }
            }
            i += 1;
            continue;
        }
        // decode one UTF-8 sequence to a code point -> \uXXXX (+ surrogate
        // pair above the BMP), matching ensure_ascii=True
        uint32_t cp = 0;
        int len = 0;
        if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; len = 2; }
        else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; len = 3; }
        else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; len = 4; }
        else { w.out.push_back(static_cast<char>(c)); i += 1; continue; }
        if (i + len > n) { w.out.push_back(static_cast<char>(c)); i += 1; continue; }
        for (int k = 1; k < len; ++k) cp = (cp << 6) | (p[i + k] & 0x3F);
        if (cp >= 0x10000) {
            uint32_t v = cp - 0x10000;
            std::snprintf(buf, sizeof buf, "\\u%04x\\u%04x",
                          0xD800 + (v >> 10), 0xDC00 + (v & 0x3FF));
        } else {
            std::snprintf(buf, sizeof buf, "\\u%04x", cp);
        }
        w.out += buf;
        i += len;
    }
    w.out.push_back('"');
}

bool encode_float(Writer& w, double v) {
    if (std::isnan(v)) { w.out += "NaN"; return true; }
    if (std::isinf(v)) { w.out += v > 0 ? "Infinity" : "-Infinity"; return true; }
    char buf[40];
    auto r = std::to_chars(buf, buf + sizeof buf, v);
    // Python float repr always carries a decimal point or exponent
    bool plain = true;
    for (char* q = buf; q != r.ptr; ++q)
        if (*q == '.' || *q == 'e' || *q == 'E') { plain = false; break; }
    w.out.append(buf, r.ptr - buf);
    if (plain) w.out += ".0";
    return true;
}

bool append_str_obj(Writer& w, PyObject* s) {
    Py_ssize_t n = 0;
    const char* c = PyUnicode_AsUTF8AndSize(s, &n);
    if (c == nullptr) return false;
    w.out.append(c, static_cast<size_t>(n));
    return true;
}

bool encode_dict(Writer& w, PyObject* obj, int depth) {
    if (PyDict_GET_SIZE(obj) == 0) { w.out += "{}"; return true; }
    w.out.push_back('{');
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    bool first = true;
    while (PyDict_Next(obj, &pos, &key, &value)) {
        if (!first) w.out += (w.indent >= 0) ? "," : ", ";
        first = false;
        if (w.indent >= 0) w.pad(depth + 1);
        if (PyUnicode_Check(key)) {
            Py_ssize_t n = 0;
            const char* c = PyUnicode_AsUTF8AndSize(key, &n);
            if (c == nullptr) return false;
            escape_string(w, c, n);
        } else {
            PyErr_SetString(PyExc_TypeError, "fastjson: non-str dict key");
            return false;
        }
        w.out += ": ";
        if (!encode(w, value, depth + 1)) return false;
    }
    if (w.indent >= 0) w.pad(depth);
    w.out.push_back('}');
    return true;
}

bool encode_seq(Writer& w, PyObject* obj, int depth) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
    if (n == 0) { w.out += "[]"; return true; }
    w.out.push_back('[');
    PyObject** items = PySequence_Fast_ITEMS(obj);
    for (Py_ssize_t i = 0; i < n; ++i) {
        if (i) w.out += (w.indent >= 0) ? "," : ", ";
        if (w.indent >= 0) w.pad(depth + 1);
        if (!encode(w, items[i], depth + 1)) return false;
    }
    if (w.indent >= 0) w.pad(depth);
    w.out.push_back(']');
    return true;
}

bool encode(Writer& w, PyObject* obj, int depth) {
    if (depth > kMaxDepth) {
        PyErr_SetString(PyExc_ValueError, "fastjson: structure too deep");
        return false;
    }
    if (obj == Py_None) { w.out += "null"; return true; }
    if (obj == Py_True) { w.out += "true"; return true; }
    if (obj == Py_False) { w.out += "false"; return true; }
    if (PyFloat_CheckExact(obj)) return encode_float(w, PyFloat_AS_DOUBLE(obj));
    if (PyUnicode_Check(obj)) {
        Py_ssize_t n = 0;
        const char* c = PyUnicode_AsUTF8AndSize(obj, &n);
        if (c == nullptr) return false;
        escape_string(w, c, n);
        return true;
    }
    if (PyLong_Check(obj)) {  // after bool (PyBool is a PyLong subtype)
        PyObject* s = PyObject_Str(obj);
        if (s == nullptr) return false;
        bool ok = append_str_obj(w, s);
        Py_DECREF(s);
        return ok;
    }
    if (PyFloat_Check(obj)) return encode_float(w, PyFloat_AS_DOUBLE(obj));
    if (PyDict_Check(obj)) return encode_dict(w, obj, depth);
    if (PyList_Check(obj) || PyTuple_Check(obj)) return encode_seq(w, obj, depth);
    // numpy scalars (shape == () or no shape): one .item() hop then retry.
    // ndarrays (shape != ()) stay unsupported -> TypeError -> stdlib
    // fallback, same as stdlib json's own behavior.
    if (PyObject_HasAttrString(obj, "item")) {
        bool scalar = true;
        if (PyObject_HasAttrString(obj, "shape")) {
            PyObject* shp = PyObject_GetAttrString(obj, "shape");
            if (shp == nullptr) return false;
            scalar = PyTuple_Check(shp) && PyTuple_GET_SIZE(shp) == 0;
            Py_DECREF(shp);
        }
        if (scalar) {
            PyObject* it = PyObject_CallMethod(obj, "item", nullptr);
            if (it == nullptr) return false;
            bool ok = encode(w, it, depth);
            Py_DECREF(it);
            return ok;
        }
    }
    PyErr_Format(PyExc_TypeError, "fastjson: unsupported type %s",
                 Py_TYPE(obj)->tp_name);
    return false;
}

PyObject* fastjson_dumps(PyObject*, PyObject* args, PyObject* kwargs) {
    PyObject* obj = nullptr;
    PyObject* indent_obj = Py_None;
    static const char* kwlist[] = {"obj", "indent", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O|O",
                                     const_cast<char**>(kwlist), &obj,
                                     &indent_obj)) {
        return nullptr;
    }
    Writer w;
    if (indent_obj != Py_None) {
        long ind = PyLong_AsLong(indent_obj);
        if (ind == -1 && PyErr_Occurred()) return nullptr;
        w.indent = ind < 0 ? 0 : static_cast<int>(ind);
    }
    w.out.reserve(1 << 16);
    if (!encode(w, obj, 0)) return nullptr;
    return PyUnicode_FromStringAndSize(w.out.data(),
                                       static_cast<Py_ssize_t>(w.out.size()));
}

PyMethodDef kMethods[] = {
    {"dumps", reinterpret_cast<PyCFunction>(fastjson_dumps),
     METH_VARARGS | METH_KEYWORDS,
     "dumps(obj, indent=None) -> str. stdlib-json-compatible serializer "
     "(ensure_ascii=True) with std::to_chars float formatting."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fastjson",
    "Native JSON serializer for calibration artifacts.", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastjson(void) { return PyModule_Create(&kModule); }
