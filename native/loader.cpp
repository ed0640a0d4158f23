// Native .crtscene loader: a from-scratch recursive-descent JSON parser
// plus crtscene field extraction behind a C ABI.
//
// Plays the role the simdjson-based DOM loader plays in the reference
// (reference: include/raytracer/io/json/loader.hpp:236-265 behavior),
// including its quirks, which are re-implemented (not translated) here:
//   * bucket_size optional, default 64,
//   * a diffuse material with a STRING albedo promotes to a texture
//     material referencing the named texture,
//   * uv arrays are consumed 3 floats per vertex, third component dropped.
// Bitmap decode stays in Python (PIL); this returns the file path.
//
// The big win is numeric-array parsing speed: dragon scenes are ~1 MB of
// float literals, which Python's json walks token by token.

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ----------------------------- JSON ---------------------------------

struct Value {
    enum Type { NUL, BOOL, NUM, STR, ARR, OBJ } type = NUL;
    bool b = false;
    double num = 0.0;
    std::string str;
    std::vector<Value> arr;
    std::vector<std::pair<std::string, Value>> obj;

    const Value* find(const char* key) const {
        for (const auto& kv : obj)
            if (kv.first == key) return &kv.second;
        return nullptr;
    }
    const Value& req(const char* key, const char* ctx) const {
        const Value* v = find(key);
        if (!v)
            throw std::runtime_error(std::string("missing required key '") +
                                     key + "' in " + ctx);
        return *v;
    }
};

struct Parser {
    const char* p;
    const char* end;

    explicit Parser(const std::string& s)
        : p(s.data()), end(s.data() + s.size()) {}

    [[noreturn]] void fail(const char* what) {
        throw std::runtime_error(std::string("JSON parse error: ") + what);
    }

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r'))
            ++p;
    }

    char peek() {
        skip_ws();
        if (p >= end) fail("unexpected end of input");
        return *p;
    }

    void expect(char c) {
        if (peek() != c) fail("unexpected character");
        ++p;
    }

    Value parse() {
        Value v = parse_value();
        skip_ws();
        return v;
    }

    Value parse_value() {
        switch (peek()) {
            case '{': return parse_object();
            case '[': return parse_array();
            case '"': {
                Value v;
                v.type = Value::STR;
                v.str = parse_string();
                return v;
            }
            case 't':
                if (end - p >= 4 && std::memcmp(p, "true", 4) == 0) {
                    p += 4;
                    Value v;
                    v.type = Value::BOOL;
                    v.b = true;
                    return v;
                }
                fail("bad literal");
            case 'f':
                if (end - p >= 5 && std::memcmp(p, "false", 5) == 0) {
                    p += 5;
                    Value v;
                    v.type = Value::BOOL;
                    v.b = false;
                    return v;
                }
                fail("bad literal");
            case 'n':
                if (end - p >= 4 && std::memcmp(p, "null", 4) == 0) {
                    p += 4;
                    return Value{};
                }
                fail("bad literal");
            default: return parse_number();
        }
    }

    std::string parse_string() {
        expect('"');
        std::string out;
        while (p < end && *p != '"') {
            if (*p == '\\') {
                ++p;
                if (p >= end) fail("bad escape");
                switch (*p) {
                    case '"': out += '"'; break;
                    case '\\': out += '\\'; break;
                    case '/': out += '/'; break;
                    case 'b': out += '\b'; break;
                    case 'f': out += '\f'; break;
                    case 'n': out += '\n'; break;
                    case 'r': out += '\r'; break;
                    case 't': out += '\t'; break;
                    case 'u': {
                        // Scene paths are ASCII; decode BMP code points
                        // to UTF-8 minimally.
                        if (end - p < 5) fail("bad \\u escape");
                        unsigned cp = 0;
                        for (int i = 1; i <= 4; ++i) {
                            char c = p[i];
                            cp <<= 4;
                            if (c >= '0' && c <= '9') cp |= c - '0';
                            else if (c >= 'a' && c <= 'f') cp |= c - 'a' + 10;
                            else if (c >= 'A' && c <= 'F') cp |= c - 'A' + 10;
                            else fail("bad \\u escape");
                        }
                        p += 4;
                        if (cp < 0x80) {
                            out += static_cast<char>(cp);
                        } else if (cp < 0x800) {
                            out += static_cast<char>(0xC0 | (cp >> 6));
                            out += static_cast<char>(0x80 | (cp & 0x3F));
                        } else {
                            out += static_cast<char>(0xE0 | (cp >> 12));
                            out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
                            out += static_cast<char>(0x80 | (cp & 0x3F));
                        }
                        break;
                    }
                    default: fail("bad escape");
                }
                ++p;
            } else {
                out += *p++;
            }
        }
        if (p >= end) fail("unterminated string");
        ++p;  // closing quote
        return out;
    }

    Value parse_number() {
        char* num_end = nullptr;
        errno = 0;
        double d = std::strtod(p, &num_end);
        if (num_end == p) fail("bad number");
        p = num_end;
        Value v;
        v.type = Value::NUM;
        v.num = d;
        return v;
    }

    Value parse_array() {
        expect('[');
        Value v;
        v.type = Value::ARR;
        if (peek() == ']') {
            ++p;
            return v;
        }
        while (true) {
            v.arr.push_back(parse_value());
            char c = peek();
            if (c == ',') {
                ++p;
            } else if (c == ']') {
                ++p;
                break;
            } else {
                fail("expected ',' or ']'");
            }
        }
        return v;
    }

    Value parse_object() {
        expect('{');
        Value v;
        v.type = Value::OBJ;
        if (peek() == '}') {
            ++p;
            return v;
        }
        while (true) {
            std::string key = parse_string();
            expect(':');
            v.obj.emplace_back(std::move(key), parse_value());
            char c = peek();
            if (c == ',') {
                ++p;
            } else if (c == '}') {
                ++p;
                break;
            } else {
                fail("expected ',' or '}'");
            }
        }
        return v;
    }
};

// --------------------------- crtscene --------------------------------

// Material tags matching simd_raytracer/models/scene.py.
enum { MAT_DIFFUSE = 0, MAT_REFLECTIVE, MAT_REFRACTIVE, MAT_CONSTANT,
       MAT_TEXTURE };
// Texture tags.
enum { TEX_ALBEDO = 0, TEX_EDGES, TEX_CHECKER, TEX_BITMAP };

struct MaterialRec {
    int32_t tag = 0;
    float albedo[3] = {0, 0, 0};
    float ior = 1.0f;
    int32_t smooth = 0;
    int32_t tex = 0;
};

struct TextureRec {
    int32_t tag = 0;
    float color_a[3] = {0, 0, 0};
    float color_b[3] = {0, 0, 0};
    float param = 1.0f;
    std::string file_path;  // bitmap only
};

struct ObjectRec {
    int32_t material_index = 0;
    std::vector<float> vertices;   // 3 per vertex
    std::vector<float> uvs;        // 2 per vertex (3rd dropped); may be empty
    std::vector<int32_t> triangles;
};

struct SceneDoc {
    int32_t height = 0, width = 0, bucket_size = 64;
    float background[3] = {0, 0, 0};
    float cam_pos[3] = {0, 0, 0};
    float cam_mat[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
    std::vector<float> light_pos;        // 3 per light
    std::vector<float> light_intensity;
    std::vector<MaterialRec> materials;
    std::vector<TextureRec> textures;
    std::vector<ObjectRec> objects;
    std::string error;  // non-empty on failure
};

void read_floats(const Value& v, float* out, size_t n, const char* ctx) {
    if (v.type != Value::ARR || v.arr.size() < n)
        throw std::runtime_error(std::string("expected ") +
                                 std::to_string(n) + " numbers in " + ctx);
    for (size_t i = 0; i < n; ++i) {
        if (v.arr[i].type != Value::NUM)
            throw std::runtime_error(std::string("non-numeric element in ") +
                                     ctx);
        out[i] = static_cast<float>(v.arr[i].num);
    }
}

// Like read_floats but for whole numeric arrays of unknown length
// (vertex/uv/index streams); rejects non-numeric elements instead of
// silently loading them as 0 (the Python loader raises there too).
void check_numeric(const Value& v, const char* ctx) {
    if (v.type != Value::ARR)
        throw std::runtime_error(std::string("expected an array in ") + ctx);
    for (const Value& e : v.arr)
        if (e.type != Value::NUM)
            throw std::runtime_error(std::string("non-numeric element in ") +
                                     ctx);
}

SceneDoc* parse_doc(const std::string& text) {
    auto doc = std::make_unique<SceneDoc>();
    Parser parser(text);
    Value root = parser.parse();

    const Value& settings = root.req("settings", "scene");
    const Value& image = settings.req("image_settings", "settings");
    doc->height =
        static_cast<int32_t>(image.req("height", "image_settings").num);
    doc->width =
        static_cast<int32_t>(image.req("width", "image_settings").num);
    if (const Value* b = image.find("bucket_size"))
        doc->bucket_size = static_cast<int32_t>(b->num);
    read_floats(settings.req("background_color", "settings"),
                doc->background, 3, "background_color");

    const Value& cam = root.req("camera", "scene");
    read_floats(cam.req("position", "camera"), doc->cam_pos, 3, "position");
    read_floats(cam.req("matrix", "camera"), doc->cam_mat, 9, "matrix");

    for (const Value& l : root.req("lights", "scene").arr) {
        float pos[3];
        read_floats(l.req("position", "light"), pos, 3, "light position");
        doc->light_pos.insert(doc->light_pos.end(), pos, pos + 3);
        doc->light_intensity.push_back(
            static_cast<float>(l.req("intensity", "light").num));
    }

    std::map<std::string, int32_t> tex_by_name;
    if (const Value* texs = root.find("textures")) {
        for (const Value& tj : texs->arr) {
            TextureRec t;
            const std::string& ttype = tj.req("type", "texture").str;
            if (ttype == "albedo") {
                t.tag = TEX_ALBEDO;
                read_floats(tj.req("albedo", "texture"), t.color_a, 3,
                            "albedo");
            } else if (ttype == "edges") {
                t.tag = TEX_EDGES;
                read_floats(tj.req("edge_color", "texture"), t.color_a, 3,
                            "edge_color");
                read_floats(tj.req("inner_color", "texture"), t.color_b, 3,
                            "inner_color");
                t.param = static_cast<float>(
                    tj.req("edge_width", "texture").num);
            } else if (ttype == "checker") {
                t.tag = TEX_CHECKER;
                read_floats(tj.req("color_A", "texture"), t.color_a, 3,
                            "color_A");
                read_floats(tj.req("color_B", "texture"), t.color_b, 3,
                            "color_B");
                t.param = static_cast<float>(
                    tj.req("square_size", "texture").num);
            } else if (ttype == "bitmap") {
                t.tag = TEX_BITMAP;
                t.file_path = tj.req("file_path", "texture").str;
            } else {
                throw std::runtime_error("texture type unknown: " + ttype);
            }
            tex_by_name[tj.req("name", "texture").str] =
                static_cast<int32_t>(doc->textures.size());
            doc->textures.push_back(std::move(t));
        }
    }

    for (const Value& mj : root.req("materials", "scene").arr) {
        MaterialRec m;
        const std::string& mtype = mj.req("type", "material").str;
        if (mtype == "diffuse") {
            const Value& albedo = mj.req("albedo", "diffuse material");
            if (albedo.type == Value::STR) {
                // String albedo promotes to a texture material.
                auto it = tex_by_name.find(albedo.str);
                if (it == tex_by_name.end())
                    throw std::runtime_error("unknown texture name: " +
                                             albedo.str);
                m.tag = MAT_TEXTURE;
                m.tex = it->second;
            } else if (albedo.type == Value::ARR) {
                m.tag = MAT_DIFFUSE;
                read_floats(albedo, m.albedo, 3, "albedo");
            } else {
                throw std::runtime_error("albedo neither array nor string");
            }
            m.smooth = mj.req("smooth_shading", "material").b ? 1 : 0;
        } else if (mtype == "reflective") {
            m.tag = MAT_REFLECTIVE;
            read_floats(mj.req("albedo", "material"), m.albedo, 3, "albedo");
            m.smooth = mj.req("smooth_shading", "material").b ? 1 : 0;
        } else if (mtype == "refractive") {
            m.tag = MAT_REFRACTIVE;
            m.ior = static_cast<float>(mj.req("ior", "material").num);
            m.smooth = mj.req("smooth_shading", "material").b ? 1 : 0;
        } else if (mtype == "constant") {
            m.tag = MAT_CONSTANT;
            read_floats(mj.req("albedo", "material"), m.albedo, 3, "albedo");
            m.smooth = mj.req("smooth_shading", "material").b ? 1 : 0;
        } else {
            throw std::runtime_error("material type unknown: " + mtype);
        }
        doc->materials.push_back(m);
    }

    for (const Value& oj : root.req("objects", "scene").arr) {
        ObjectRec o;
        o.material_index = static_cast<int32_t>(
            oj.req("material_index", "object").num);
        const Value& verts = oj.req("vertices", "object");
        check_numeric(verts, "object vertices");
        if (verts.arr.size() % 3 != 0)
            throw std::runtime_error("vertex coordinates not multiple of 3");
        o.vertices.reserve(verts.arr.size());
        for (const Value& x : verts.arr)
            o.vertices.push_back(static_cast<float>(x.num));
        if (const Value* uvs = oj.find("uvs")) {
            check_numeric(*uvs, "object uvs");
            if (uvs->arr.size() % 3 != 0)
                throw std::runtime_error("uv coordinates not multiple of 3");
            // 3 floats consumed per vertex, third dropped.
            o.uvs.reserve(uvs->arr.size() / 3 * 2);
            for (size_t i = 0; i + 2 < uvs->arr.size(); i += 3) {
                o.uvs.push_back(static_cast<float>(uvs->arr[i].num));
                o.uvs.push_back(static_cast<float>(uvs->arr[i + 1].num));
            }
        }
        const Value& tris = oj.req("triangles", "object");
        check_numeric(tris, "object triangles");
        if (tris.arr.size() % 3 != 0)
            throw std::runtime_error("triangle indices not multiple of 3");
        o.triangles.reserve(tris.arr.size());
        for (const Value& x : tris.arr)
            o.triangles.push_back(static_cast<int32_t>(x.num));
        doc->objects.push_back(std::move(o));
    }

    return doc.release();
}

}  // namespace

extern "C" {

// Parse a scene file.  Always returns a handle; check srt_scene_error.
void* srt_scene_parse(const char* path) {
    auto* doc = new SceneDoc();
    FILE* f = std::fopen(path, "rb");
    if (!f) {
        doc->error = std::string("cannot open ") + path;
        return doc;
    }
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    // Guard ftell failure (directories, pipes) and absurd sizes so the
    // allocation below can't throw length_error across the C ABI; errors
    // travel through doc->error like every other loader failure.
    constexpr long kMaxSceneBytes = 1L << 31;  // 2 GiB
    if (size < 0 || size > kMaxSceneBytes) {
        std::fclose(f);
        doc->error = std::string("cannot determine size of ") + path +
                     " (not a regular file, or > 2 GiB)";
        return doc;
    }
    std::string text(static_cast<size_t>(size), '\0');
    size_t got = std::fread(text.data(), 1, text.size(), f);
    std::fclose(f);
    text.resize(got);
    try {
        SceneDoc* parsed = parse_doc(text);
        delete doc;
        return parsed;
    } catch (const std::exception& e) {
        doc->error = e.what();
        return doc;
    }
}

const char* srt_scene_error(void* handle) {
    auto* doc = static_cast<SceneDoc*>(handle);
    return doc->error.empty() ? nullptr : doc->error.c_str();
}

void srt_scene_header(void* handle, int32_t* h, int32_t* w,
                      int32_t* bucket, float* background, float* cam_pos,
                      float* cam_mat, int32_t* n_lights,
                      int32_t* n_materials, int32_t* n_textures,
                      int32_t* n_objects) {
    auto* doc = static_cast<SceneDoc*>(handle);
    *h = doc->height;
    *w = doc->width;
    *bucket = doc->bucket_size;
    std::memcpy(background, doc->background, sizeof doc->background);
    std::memcpy(cam_pos, doc->cam_pos, sizeof doc->cam_pos);
    std::memcpy(cam_mat, doc->cam_mat, sizeof doc->cam_mat);
    *n_lights = static_cast<int32_t>(doc->light_intensity.size());
    *n_materials = static_cast<int32_t>(doc->materials.size());
    *n_textures = static_cast<int32_t>(doc->textures.size());
    *n_objects = static_cast<int32_t>(doc->objects.size());
}

void srt_scene_lights(void* handle, float* pos, float* intensity) {
    auto* doc = static_cast<SceneDoc*>(handle);
    std::memcpy(pos, doc->light_pos.data(),
                doc->light_pos.size() * sizeof(float));
    std::memcpy(intensity, doc->light_intensity.data(),
                doc->light_intensity.size() * sizeof(float));
}

void srt_scene_material(void* handle, int32_t i, int32_t* tag,
                        float* albedo, float* ior, int32_t* smooth,
                        int32_t* tex) {
    const MaterialRec& m = static_cast<SceneDoc*>(handle)->materials[i];
    *tag = m.tag;
    std::memcpy(albedo, m.albedo, sizeof m.albedo);
    *ior = m.ior;
    *smooth = m.smooth;
    *tex = m.tex;
}

// Returns the bitmap path length (0 for non-bitmap textures); copies at
// most path_cap bytes (no NUL) into path_out.
int32_t srt_scene_texture(void* handle, int32_t i, int32_t* tag,
                          float* color_a, float* color_b, float* param,
                          char* path_out, int32_t path_cap) {
    const TextureRec& t = static_cast<SceneDoc*>(handle)->textures[i];
    *tag = t.tag;
    std::memcpy(color_a, t.color_a, sizeof t.color_a);
    std::memcpy(color_b, t.color_b, sizeof t.color_b);
    *param = t.param;
    int32_t n = static_cast<int32_t>(t.file_path.size());
    if (path_out && path_cap > 0)
        std::memcpy(path_out, t.file_path.data(),
                    std::min(n, path_cap));
    return n;
}

void srt_scene_object_counts(void* handle, int32_t i, int32_t* mat_index,
                             int32_t* n_vertex_floats, int32_t* n_uv_floats,
                             int32_t* n_tri_indices) {
    const ObjectRec& o = static_cast<SceneDoc*>(handle)->objects[i];
    *mat_index = o.material_index;
    *n_vertex_floats = static_cast<int32_t>(o.vertices.size());
    *n_uv_floats = static_cast<int32_t>(o.uvs.size());
    *n_tri_indices = static_cast<int32_t>(o.triangles.size());
}

void srt_scene_object_data(void* handle, int32_t i, float* vertices,
                           float* uvs, int32_t* triangles) {
    const ObjectRec& o = static_cast<SceneDoc*>(handle)->objects[i];
    std::memcpy(vertices, o.vertices.data(),
                o.vertices.size() * sizeof(float));
    if (!o.uvs.empty())
        std::memcpy(uvs, o.uvs.data(), o.uvs.size() * sizeof(float));
    std::memcpy(triangles, o.triangles.data(),
                o.triangles.size() * sizeof(int32_t));
}

void srt_scene_free(void* handle) { delete static_cast<SceneDoc*>(handle); }

}  // extern "C"
