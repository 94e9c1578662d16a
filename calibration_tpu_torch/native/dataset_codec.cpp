// Native dataset codec: fast JSON detections parsing + padded-array packing.
//
// The reference library's IO layer is C++ (nlohmann_json aggregate
// reflection, include/calib/io/json.h); this is the TPU framework's native
// equivalent for the hot ingest path: parse a calib_dataset planar-detections
// JSON payload (schemas/calib_dataset.schema.json) and pack the ragged
// per-image point lists straight into contiguous, padded float64 buffers
// (obj_xy[V,N,2], img_uv[V,N,2], mask[V,N]) that device code consumes —
// no per-point Python objects anywhere.
//
// Exposed through a C ABI consumed via ctypes (calibration_tpu/native/__init__.py).
// Build: g++ -O3 -fPIC -shared -std=c++17 dataset_codec.cpp -o _dataset_codec.so

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal recursive-descent JSON parser specialised for the dataset schema.
// Only the value shapes the schema uses are materialised; everything else is
// skipped structurally (strings/numbers/objects/arrays), which keeps the
// parse allocation-light.
// ---------------------------------------------------------------------------

struct Point {
  double x = 0.0, y = 0.0;
  double local_x = 0.0, local_y = 0.0, local_z = 0.0;
  long long id = -1;
};

struct Image {
  std::string file;
  std::vector<Point> points;
};

struct Detections {
  std::string sensor_id;
  std::string feature_type;
  std::string image_directory;
  std::string algo_version;
  std::string params_hash;
  std::vector<std::string> tags;
  std::vector<Image> images;
  // Top-level JSON object with the "images" member removed, re-emitted
  // verbatim (byte spans of the source). Lets Python rebuild the
  // PlanarDetections header (metadata, sensor_id, ...) without paying a
  // full json.loads of the multi-MB payload.
  std::string header_json;
  std::string error;  // non-empty on parse failure
};

class Parser {
 public:
  Parser(const char* data, size_t len) : p_(data), end_(data + len) {}

  bool parse(Detections* out) {
    skip_ws();
    if (!parse_detections_object(out)) {
      out->error = err_.empty() ? "malformed JSON" : err_;
      return false;
    }
    return true;
  }

 private:
  const char* p_;
  const char* end_;
  std::string err_;

  void skip_ws() {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' || *p_ == '\r')) ++p_;
  }

  bool consume(char c) {
    skip_ws();
    if (p_ < end_ && *p_ == c) {
      ++p_;
      return true;
    }
    return false;
  }

  bool peek(char c) {
    skip_ws();
    return p_ < end_ && *p_ == c;
  }

  bool parse_string(std::string* out) {
    skip_ws();
    if (p_ >= end_ || *p_ != '"') return fail("expected string");
    ++p_;
    out->clear();
    while (p_ < end_) {
      char c = *p_++;
      if (c == '"') return true;
      if (c == '\\') {
        if (p_ >= end_) return fail("bad escape");
        char e = *p_++;
        switch (e) {
          case '"': out->push_back('"'); break;
          case '\\': out->push_back('\\'); break;
          case '/': out->push_back('/'); break;
          case 'b': out->push_back('\b'); break;
          case 'f': out->push_back('\f'); break;
          case 'n': out->push_back('\n'); break;
          case 'r': out->push_back('\r'); break;
          case 't': out->push_back('\t'); break;
          case 'u': {
            if (end_ - p_ < 4) return fail("bad \\u escape");
            unsigned code = 0;
            for (int i = 0; i < 4; ++i) {
              char h = *p_++;
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else return fail("bad hex digit");
            }
            // UTF-8 encode (BMP only; surrogate pairs folded naively)
            if (code < 0x80) {
              out->push_back(static_cast<char>(code));
            } else if (code < 0x800) {
              out->push_back(static_cast<char>(0xC0 | (code >> 6)));
              out->push_back(static_cast<char>(0x80 | (code & 0x3F)));
            } else {
              out->push_back(static_cast<char>(0xE0 | (code >> 12)));
              out->push_back(static_cast<char>(0x80 | ((code >> 6) & 0x3F)));
              out->push_back(static_cast<char>(0x80 | (code & 0x3F)));
            }
            break;
          }
          default: return fail("unknown escape");
        }
      } else {
        out->push_back(c);
      }
    }
    return fail("unterminated string");
  }

  bool parse_number(double* out) {
    skip_ws();
    char* endp = nullptr;
    *out = std::strtod(p_, &endp);
    if (endp == p_) return fail("expected number");
    p_ = endp;
    return true;
  }

  bool skip_value() {
    skip_ws();
    if (p_ >= end_) return fail("unexpected end");
    char c = *p_;
    if (c == '"') {
      std::string tmp;
      return parse_string(&tmp);
    }
    if (c == '{') {
      ++p_;
      if (consume('}')) return true;
      while (true) {
        std::string key;
        if (!parse_string(&key) || !consume(':') || !skip_value()) return false;
        if (consume(',')) continue;
        return consume('}') || fail("expected } in object");
      }
    }
    if (c == '[') {
      ++p_;
      if (consume(']')) return true;
      while (true) {
        if (!skip_value()) return false;
        if (consume(',')) continue;
        return consume(']') || fail("expected ] in array");
      }
    }
    if (c == 't') return expect("true");
    if (c == 'f') return expect("false");
    if (c == 'n') return expect("null");
    double d;
    return parse_number(&d);
  }

  bool expect(const char* lit) {
    size_t n = std::strlen(lit);
    if (static_cast<size_t>(end_ - p_) < n || std::strncmp(p_, lit, n) != 0)
      return fail("bad literal");
    p_ += n;
    return true;
  }

  bool fail(const char* msg) {
    if (err_.empty()) err_ = msg;
    return false;
  }

  // Dual-key payloads (io/json.h writes BOTH field_N and the member name
  // for every field) must not be double-ingested: a named key always wins
  // and re-parses its slot (list slots are cleared first); a positional
  // field_N key is skipped once its named twin has been seen. ``named`` is
  // a per-object bitmask of slots already filled from named keys.
  //
  // slot(): -1 = unknown key (structurally skipped), otherwise the field
  // index in the aggregate layout; *is_named reports which key form matched.
  static int point_slot(const std::string& key, bool* is_named) {
    static const char* names[] = {"x", "y", "id", "local_x", "local_y", "local_z"};
    return find_slot(key, names, 6, is_named);
  }

  static int image_slot(const std::string& key, bool* is_named) {
    static const char* names[] = {"file", "points"};
    return find_slot(key, names, 2, is_named);
  }

  static int detections_slot(const std::string& key, bool* is_named) {
    static const char* names[] = {
        "image_directory", "feature_type", "algo_version", "params_hash",
        "sensor_id",       "tags",         "metadata",     "source_file",
        "images"};
    return find_slot(key, names, 9, is_named);
  }

  static int find_slot(const std::string& key, const char* const* names,
                       int n, bool* is_named) {
    for (int i = 0; i < n; ++i) {
      if (key == names[i]) {
        *is_named = true;
        return i;
      }
    }
    if (key.size() > 6 && key.compare(0, 6, "field_") == 0) {
      int idx = std::atoi(key.c_str() + 6);
      if (idx >= 0 && idx < n) {
        *is_named = false;
        return idx;
      }
    }
    *is_named = false;
    return -1;
  }

  bool parse_point(Point* pt) {
    if (!consume('{')) return fail("expected point object");
    if (consume('}')) return true;
    unsigned named = 0;
    while (true) {
      std::string key;
      if (!parse_string(&key) || !consume(':')) return false;
      bool is_named = false;
      int slot = point_slot(key, &is_named);
      if (slot < 0 || (!is_named && (named & (1u << slot)))) {
        if (!skip_value()) return false;
      } else {
        if (is_named) named |= 1u << slot;
        double d;
        switch (slot) {
          case 0: if (!parse_number(&pt->x)) return false; break;
          case 1: if (!parse_number(&pt->y)) return false; break;
          case 2:
            if (!parse_number(&d)) return false;
            pt->id = static_cast<long long>(d);
            break;
          case 3: if (!parse_number(&pt->local_x)) return false; break;
          case 4: if (!parse_number(&pt->local_y)) return false; break;
          case 5: if (!parse_number(&pt->local_z)) return false; break;
        }
      }
      if (consume(',')) continue;
      return consume('}') || fail("expected } in point");
    }
  }

  bool parse_image(Image* img) {
    if (!consume('{')) return fail("expected image object");
    if (consume('}')) return true;
    unsigned named = 0;
    while (true) {
      std::string key;
      if (!parse_string(&key) || !consume(':')) return false;
      bool is_named = false;
      int slot = image_slot(key, &is_named);
      if (slot < 0 || (!is_named && (named & (1u << slot)))) {
        if (!skip_value()) return false;
      } else {
        if (is_named) named |= 1u << slot;
        if (slot == 0) {
          if (!parse_string(&img->file)) return false;
        } else {  // points
          img->points.clear();
          if (!consume('[')) return fail("expected points array");
          if (!consume(']')) {
            while (true) {
              img->points.emplace_back();
              if (!parse_point(&img->points.back())) return false;
              if (consume(',')) continue;
              if (consume(']')) break;
              return fail("expected ] in points");
            }
          }
        }
      }
      if (consume(',')) continue;
      return consume('}') || fail("expected } in image");
    }
  }

  bool parse_detections_object(Detections* det) {
    if (!consume('{')) return fail("expected top-level object");
    det->header_json = "{";
    if (consume('}')) {
      det->header_json += "}";
      return true;
    }
    // aggregate layout (dataset.h:29-39): image_directory, feature_type,
    // algo_version, params_hash, sensor_id, tags, metadata, source_file,
    // images. metadata/source_file (slots 6/7) are not materialised here —
    // they ride through header_json verbatim and the Python reflection
    // layer (io/jsonio.from_jsonable) resolves their named/positional keys.
    unsigned named = 0;
    while (true) {
      skip_ws();
      const char* pair_start = p_;  // at the opening quote of the key
      std::string key;
      if (!parse_string(&key) || !consume(':')) return false;
      bool is_named = false;
      int slot = detections_slot(key, &is_named);
      bool is_images = (slot == 8);
      if (slot < 0 || slot == 6 || slot == 7 ||
          (!is_named && (named & (1u << slot)))) {
        if (!skip_value()) return false;
      } else {
        if (is_named) named |= 1u << slot;
        switch (slot) {
          case 0: if (!parse_string(&det->image_directory)) return false; break;
          case 1: if (!parse_string(&det->feature_type)) return false; break;
          case 2: if (!parse_string(&det->algo_version)) return false; break;
          case 3: if (!parse_string(&det->params_hash)) return false; break;
          case 4: if (!parse_string(&det->sensor_id)) return false; break;
          case 5:
            if (peek('[')) {
              det->tags.clear();
              consume('[');
              if (!consume(']')) {
                while (true) {
                  std::string tag;
                  if (!parse_string(&tag)) return false;
                  det->tags.push_back(std::move(tag));
                  if (consume(',')) continue;
                  if (consume(']')) break;
                  return fail("expected ] in tags");
                }
              }
            } else if (!skip_value()) {
              return false;
            }
            break;
          case 8:
            det->images.clear();
            if (!consume('[')) return fail("expected images array");
            if (!consume(']')) {
              while (true) {
                det->images.emplace_back();
                if (!parse_image(&det->images.back())) return false;
                if (consume(',')) continue;
                if (consume(']')) break;
                return fail("expected ] in images");
              }
            }
            break;
        }
      }
      if (!is_images) {
        if (det->header_json.size() > 1) det->header_json += ",";
        det->header_json.append(pair_start, static_cast<size_t>(p_ - pair_start));
      }
      if (consume(',')) continue;
      if (consume('}')) {
        det->header_json += "}";
        return true;
      }
      return fail("expected } at top level");
    }
  }
};

}  // namespace

extern "C" {

void* ctpu_parse_detections(const char* data, size_t len) {
  auto* det = new Detections();
  Parser parser(data, len);
  parser.parse(det);  // error recorded in det->error
  return det;
}

const char* ctpu_error(void* handle) {
  auto* det = static_cast<Detections*>(handle);
  return det->error.c_str();
}

const char* ctpu_sensor_id(void* handle) {
  return static_cast<Detections*>(handle)->sensor_id.c_str();
}

const char* ctpu_feature_type(void* handle) {
  return static_cast<Detections*>(handle)->feature_type.c_str();
}

// Top-level object minus "images", emitted verbatim from the source bytes
// (see Detections::header_json). Empty string on parse failure.
const char* ctpu_header_json(void* handle) {
  return static_cast<Detections*>(handle)->header_json.c_str();
}

int64_t ctpu_num_images(void* handle) {
  return static_cast<int64_t>(static_cast<Detections*>(handle)->images.size());
}

int64_t ctpu_num_points(void* handle, int64_t image_idx) {
  auto* det = static_cast<Detections*>(handle);
  if (image_idx < 0 || image_idx >= static_cast<int64_t>(det->images.size())) return -1;
  return static_cast<int64_t>(det->images[image_idx].points.size());
}

int64_t ctpu_max_points(void* handle) {
  auto* det = static_cast<Detections*>(handle);
  int64_t m = 0;
  for (const auto& img : det->images)
    if (static_cast<int64_t>(img.points.size()) > m) m = static_cast<int64_t>(img.points.size());
  return m;
}

const char* ctpu_image_file(void* handle, int64_t image_idx) {
  auto* det = static_cast<Detections*>(handle);
  if (image_idx < 0 || image_idx >= static_cast<int64_t>(det->images.size())) return "";
  return det->images[image_idx].file.c_str();
}

int64_t ctpu_num_tags(void* handle) {
  return static_cast<int64_t>(static_cast<Detections*>(handle)->tags.size());
}

const char* ctpu_tag(void* handle, int64_t idx) {
  auto* det = static_cast<Detections*>(handle);
  if (idx < 0 || idx >= static_cast<int64_t>(det->tags.size())) return "";
  return det->tags[idx].c_str();
}

// Pack all images with >= min_points detections into padded [V, pad_n] buffers.
// obj_xy/img_uv are row-major [V, pad_n, 2]; mask is [V, pad_n] (0/1);
// point_ids is [V, pad_n] int64 (-1 when padded). Returns the number of views
// written (V). Buffers must be sized with V = ctpu_count_views(min_points)
// and pad_n >= ctpu_max_points().
int64_t ctpu_count_views(void* handle, int64_t min_points) {
  auto* det = static_cast<Detections*>(handle);
  int64_t v = 0;
  for (const auto& img : det->images)
    if (static_cast<int64_t>(img.points.size()) >= min_points) ++v;
  return v;
}

int64_t ctpu_pack(void* handle, int64_t min_points, int64_t pad_n, double* obj_xy,
                  double* img_uv, uint8_t* mask, int64_t* point_ids) {
  auto* det = static_cast<Detections*>(handle);
  int64_t v = 0;
  for (const auto& img : det->images) {
    const int64_t n = static_cast<int64_t>(img.points.size());
    if (n < min_points || n > pad_n) {
      if (n < min_points) continue;
      return -1;  // caller sized pad_n too small
    }
    double* o = obj_xy + v * pad_n * 2;
    double* u = img_uv + v * pad_n * 2;
    uint8_t* m = mask + v * pad_n;
    int64_t* ids = point_ids + v * pad_n;
    for (int64_t i = 0; i < n; ++i) {
      const Point& pt = img.points[i];
      o[2 * i] = pt.local_x;
      o[2 * i + 1] = pt.local_y;
      u[2 * i] = pt.x;
      u[2 * i + 1] = pt.y;
      m[i] = 1;
      ids[i] = pt.id;
    }
    for (int64_t i = n; i < pad_n; ++i) {
      o[2 * i] = o[2 * i + 1] = 0.0;
      u[2 * i] = u[2 * i + 1] = 0.0;
      m[i] = 0;
      ids[i] = -1;
    }
    ++v;
  }
  return v;
}

void ctpu_free(void* handle) { delete static_cast<Detections*>(handle); }

}  // extern "C"
