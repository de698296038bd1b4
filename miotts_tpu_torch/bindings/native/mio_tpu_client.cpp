// mio_tpu_client implementation — see mio_tpu_client.h. The port's copy of
// the JAX package's miotts_tpu/bindings/native/mio_tpu_client.cpp, unchanged
// but for these comments: the same C ABI against the port's server
// (miotts_tpu_torch/serving/server.py), whose routes are the JAX server's.
//
// One TCP connection per request (Connection: close): reference-bridge
// call rates are human-driven, so connection reuse buys nothing and this
// keeps the state machine trivial. Handles Content-Length and chunked
// transfer coding (the server streams WAV bodies chunked,
// miotts_tpu_torch/serving/server.py).

#include "mio_tpu_client.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Client {
    std::string host;
    int port = 80;
    // generation defaults (negative => leave to server)
    int32_t n_predict = -1;
    int32_t top_k = -1;
    float top_p = -1.0f;
    float temp = -1.0f;
    float repeat_penalty = -1.0f;
    int32_t seed = -12345678;  // sentinel: unset
};

void set_err(char * err, size_t err_size, const std::string & msg) {
    if (err && err_size) {
        std::snprintf(err, err_size, "%s", msg.c_str());
    }
}

bool parse_base_url(const std::string & url, Client & c, std::string & msg) {
    const std::string scheme = "http://";
    if (url.compare(0, scheme.size(), scheme) != 0) {
        msg = "base_url must start with http:// (got: " + url + ")";
        return false;
    }
    std::string rest = url.substr(scheme.size());
    // strip any trailing path
    size_t slash = rest.find('/');
    if (slash != std::string::npos) rest = rest.substr(0, slash);
    size_t colon = rest.rfind(':');
    if (colon == std::string::npos) {
        c.host = rest;
        c.port = 80;
    } else {
        c.host = rest.substr(0, colon);
        c.port = std::atoi(rest.c_str() + colon + 1);
    }
    if (c.host.empty() || c.port <= 0 || c.port > 65535) {
        msg = "invalid host/port in base_url: " + url;
        return false;
    }
    return true;
}

int dial(const Client & c, std::string & msg) {
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo * res = nullptr;
    char portbuf[16];
    std::snprintf(portbuf, sizeof portbuf, "%d", c.port);
    int rc = getaddrinfo(c.host.c_str(), portbuf, &hints, &res);
    if (rc != 0) {
        msg = std::string("resolve failed: ") + gai_strerror(rc);
        return -1;
    }
    int fd = -1;
    for (addrinfo * ai = res; ai; ai = ai->ai_next) {
        fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
        close(fd);
        fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0) msg = "connect failed to " + c.host + ":" + portbuf;
    return fd;
}

bool send_all(int fd, const char * p, size_t n, std::string & msg) {
    while (n) {
        ssize_t w = write(fd, p, n);
        if (w <= 0) {
            msg = "socket write failed";
            return false;
        }
        p += w;
        n -= static_cast<size_t>(w);
    }
    return true;
}

struct Response {
    int status = 0;
    std::map<std::string, std::string> headers;  // lowercase keys
    std::string body;
};

bool read_response(int fd, Response & out, std::string & msg) {
    std::string raw;
    char buf[16384];
    // read headers
    size_t hdr_end;
    for (;;) {
        hdr_end = raw.find("\r\n\r\n");
        if (hdr_end != std::string::npos) break;
        ssize_t r = read(fd, buf, sizeof buf);
        if (r <= 0) {
            msg = "connection closed before response headers";
            return false;
        }
        raw.append(buf, static_cast<size_t>(r));
    }
    std::istringstream head(raw.substr(0, hdr_end));
    std::string line;
    std::getline(head, line);
    if (line.size() < 12 || line.compare(0, 5, "HTTP/") != 0) {
        msg = "malformed status line: " + line;
        return false;
    }
    out.status = std::atoi(line.c_str() + 9);
    while (std::getline(head, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        size_t c = line.find(':');
        if (c == std::string::npos) continue;
        std::string k = line.substr(0, c);
        for (auto & ch : k) ch = static_cast<char>(std::tolower(ch));
        size_t v = c + 1;
        while (v < line.size() && line[v] == ' ') v++;
        out.headers[k] = line.substr(v);
    }
    std::string rest = raw.substr(hdr_end + 4);

    auto read_more = [&](std::string & dst) -> bool {
        ssize_t r = read(fd, buf, sizeof buf);
        if (r <= 0) return false;
        dst.append(buf, static_cast<size_t>(r));
        return true;
    };

    auto te = out.headers.find("transfer-encoding");
    if (te != out.headers.end() && te->second.find("chunked") != std::string::npos) {
        // chunked decode
        std::string & s = rest;
        size_t pos = 0;
        for (;;) {
            size_t eol;
            while ((eol = s.find("\r\n", pos)) == std::string::npos) {
                if (!read_more(s)) { msg = "eof in chunk size"; return false; }
            }
            size_t chunk = std::strtoul(s.substr(pos, eol - pos).c_str(), nullptr, 16);
            pos = eol + 2;
            if (chunk == 0) break;
            while (s.size() < pos + chunk + 2) {
                if (!read_more(s)) { msg = "eof in chunk body"; return false; }
            }
            out.body.append(s, pos, chunk);
            pos += chunk + 2;  // skip trailing CRLF
        }
        return true;
    }
    auto cl = out.headers.find("content-length");
    if (cl != out.headers.end()) {
        size_t want = std::strtoul(cl->second.c_str(), nullptr, 10);
        out.body = rest;
        while (out.body.size() < want) {
            if (!read_more(out.body)) { msg = "eof before content-length"; return false; }
        }
        out.body.resize(want);
        return true;
    }
    // read to EOF (Connection: close)
    out.body = rest;
    while (read_more(out.body)) {}
    return true;
}

bool request(const Client & c, const std::string & method, const std::string & path,
             const std::string & content_type, const std::string & body,
             Response & out, std::string & msg) {
    int fd = dial(c, msg);
    if (fd < 0) return false;
    std::ostringstream req;
    req << method << " " << path << " HTTP/1.1\r\n"
        << "Host: " << c.host << ":" << c.port << "\r\n"
        << "Connection: close\r\n";
    if (!body.empty() || method == "POST") {
        req << "Content-Type: " << content_type << "\r\n"
            << "Content-Length: " << body.size() << "\r\n";
    }
    req << "\r\n";
    std::string head = req.str();
    bool ok = send_all(fd, head.data(), head.size(), msg) &&
              (body.empty() || send_all(fd, body.data(), body.size(), msg)) &&
              read_response(fd, out, msg);
    close(fd);
    return ok;
}

std::string json_escape(const std::string & s) {
    std::string o;
    o.reserve(s.size() + 8);
    for (unsigned char ch : s) {
        switch (ch) {
            case '"': o += "\\\""; break;
            case '\\': o += "\\\\"; break;
            case '\n': o += "\\n"; break;
            case '\r': o += "\\r"; break;
            case '\t': o += "\\t"; break;
            default:
                if (ch < 0x20) {
                    char u[8];
                    std::snprintf(u, sizeof u, "\\u%04x", ch);
                    o += u;
                } else {
                    o += static_cast<char>(ch);
                }
        }
    }
    return o;
}

// Pull "message" out of the server's error JSON; fall back to the raw body.
std::string error_message(const Response & r) {
    const std::string key = "\"message\":";
    size_t p = r.body.find(key);
    if (p != std::string::npos) {
        p = r.body.find('"', p + key.size());
        if (p != std::string::npos) {
            size_t e = p + 1;
            while (e < r.body.size() && !(r.body[e] == '"' && r.body[e - 1] != '\\')) e++;
            return r.body.substr(p + 1, e - p - 1);
        }
    }
    return "HTTP " + std::to_string(r.status) + ": " + r.body.substr(0, 200);
}

bool read_file(const std::string & path, std::string & out, std::string & msg) {
    std::ifstream f(path, std::ios::binary);
    if (!f) {
        msg = "cannot open file: " + path;
        return false;
    }
    std::ostringstream ss;
    ss << f.rdbuf();
    out = ss.str();
    return true;
}

bool write_file(const std::string & path, const std::string & data, std::string & msg) {
    std::ofstream f(path, std::ios::binary);
    if (!f || !f.write(data.data(), static_cast<std::streamsize>(data.size()))) {
        msg = "cannot write file: " + path;
        return false;
    }
    return true;
}

std::string multipart(const std::string & boundary,
                      const std::vector<std::pair<std::string, std::string>> & fields,
                      const std::string & file_field, const std::string & filename,
                      const std::string & file_data) {
    std::string b;
    for (auto & kv : fields) {
        b += "--" + boundary + "\r\nContent-Disposition: form-data; name=\"" +
             kv.first + "\"\r\n\r\n" + kv.second + "\r\n";
    }
    b += "--" + boundary + "\r\nContent-Disposition: form-data; name=\"" +
         file_field + "\"; filename=\"" + filename +
         "\"\r\nContent-Type: application/octet-stream\r\n\r\n" + file_data + "\r\n";
    b += "--" + boundary + "--\r\n";
    return b;
}

std::string basename_of(const std::string & path) {
    size_t p = path.find_last_of('/');
    return p == std::string::npos ? path : path.substr(p + 1);
}

// Append the client's generation defaults to a JSON object under construction.
void append_params(const Client & c, std::ostringstream & j, int32_t n_predict) {
    if (n_predict > 0) j << ", \"n_predict\": " << n_predict;
    else if (c.n_predict > 0) j << ", \"n_predict\": " << c.n_predict;
    if (c.top_k >= 0) j << ", \"top_k\": " << c.top_k;
    if (c.top_p >= 0.0f) j << ", \"top_p\": " << c.top_p;
    if (c.temp >= 0.0f) j << ", \"temp\": " << c.temp;
    if (c.repeat_penalty >= 0.0f) j << ", \"repeat_penalty\": " << c.repeat_penalty;
    if (c.seed != -12345678) j << ", \"seed\": " << c.seed;
}

char * dup_cstr(const std::string & s) {
    char * p = static_cast<char *>(std::malloc(s.size() + 1));
    if (p) std::memcpy(p, s.c_str(), s.size() + 1);
    return p;
}

bool synthesize_common(Client * c, const std::string & body,
                       const char * output_wav_path, char * err, size_t err_size) {
    Response r;
    std::string msg;
    if (!request(*c, "POST", "/mio/tts/stream", "application/json", body, r, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    if (r.status != 200) {
        set_err(err, err_size, error_message(r));
        return false;
    }
    if (r.body.size() < 44 || r.body.compare(0, 4, "RIFF") != 0) {
        set_err(err, err_size, "server did not return a WAV body");
        return false;
    }
    if (!write_file(output_wav_path, r.body, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    return true;
}

}  // namespace

extern "C" {

void * mio_tpu_client_create(const char * base_url, char * err, size_t err_size) {
    if (!base_url) {
        set_err(err, err_size, "base_url is null");
        return nullptr;
    }
    auto * c = new Client();
    std::string msg;
    if (!parse_base_url(base_url, *c, msg)) {
        set_err(err, err_size, msg);
        delete c;
        return nullptr;
    }
    Response r;
    if (!request(*c, "GET", "/health", "", "", r, msg) || r.status != 200) {
        set_err(err, err_size, msg.empty() ? error_message(r) : msg);
        delete c;
        return nullptr;
    }
    return c;
}

void mio_tpu_client_destroy(void * handle) {
    delete static_cast<Client *>(handle);
}

bool mio_tpu_client_set_generation_params(
        void * handle, int32_t n_predict, int32_t top_k, float top_p,
        float temp, float repeat_penalty, int32_t seed,
        char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c) {
        set_err(err, err_size, "null handle");
        return false;
    }
    c->n_predict = n_predict;
    c->top_k = top_k;
    c->top_p = top_p;
    c->temp = temp;
    c->repeat_penalty = repeat_penalty;
    c->seed = seed;
    return true;
}

static bool get_json(void * handle, const char * path, char ** json_out,
                     char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c || !json_out) {
        set_err(err, err_size, "null handle or out pointer");
        return false;
    }
    Response r;
    std::string msg;
    if (!request(*c, "GET", path, "", "", r, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    if (r.status != 200) {
        set_err(err, err_size, error_message(r));
        return false;
    }
    *json_out = dup_cstr(r.body);
    return *json_out != nullptr;
}

bool mio_tpu_client_health_json(void * handle, char ** json_out,
                                char * err, size_t err_size) {
    return get_json(handle, "/mio/health", json_out, err, err_size);
}

bool mio_tpu_client_list_references_json(void * handle, char ** json_out,
                                         char * err, size_t err_size) {
    return get_json(handle, "/mio/references", json_out, err, err_size);
}

bool mio_tpu_client_create_reference_from_audio(
        void * handle, const char * reference_key, const char * audio_path,
        float max_reference_seconds, const char * embedding_out_path,
        char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c || !reference_key || !audio_path) {
        set_err(err, err_size, "null argument");
        return false;
    }
    std::string audio, msg;
    if (!read_file(audio_path, audio, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    const std::string boundary = "mio-tpu-client-7f3a9c51e2d84b06";
    std::vector<std::pair<std::string, std::string>> fields = {
        {"reference_key", reference_key}};
    if (max_reference_seconds > 0) {
        char f[32];
        std::snprintf(f, sizeof f, "%g", max_reference_seconds);
        fields.emplace_back("max_reference_seconds", f);
    }
    std::string body = multipart(boundary, fields, "audio",
                                 basename_of(audio_path), audio);
    Response r;
    if (!request(*c, "POST", "/mio/generate_reference",
                 "multipart/form-data; boundary=" + boundary, body, r, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    if (r.status != 200) {
        set_err(err, err_size, error_message(r));
        return false;
    }
    if (embedding_out_path && *embedding_out_path) {
        if (!write_file(embedding_out_path, r.body, msg)) {
            set_err(err, err_size, msg);
            return false;
        }
    }
    return true;
}

bool mio_tpu_client_add_reference_from_gguf(
        void * handle, const char * reference_key, const char * embedding_path,
        char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c || !reference_key || !embedding_path) {
        set_err(err, err_size, "null argument");
        return false;
    }
    std::string gguf, msg;
    if (!read_file(embedding_path, gguf, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    const std::string boundary = "mio-tpu-client-7f3a9c51e2d84b06";
    std::string body = multipart(boundary, {{"reference_key", reference_key}},
                                 "file", basename_of(embedding_path), gguf);
    Response r;
    if (!request(*c, "POST", "/mio/add_reference",
                 "multipart/form-data; boundary=" + boundary, body, r, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    if (r.status != 200) {
        set_err(err, err_size, error_message(r));
        return false;
    }
    return true;
}

bool mio_tpu_client_remove_reference(
        void * handle, const char * reference_key, char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c || !reference_key) {
        set_err(err, err_size, "null argument");
        return false;
    }
    std::string body = "{\"reference_key\": \"" +
                       json_escape(reference_key) + "\"}";
    Response r;
    std::string msg;
    if (!request(*c, "POST", "/mio/delete_reference", "application/json",
                 body, r, msg)) {
        set_err(err, err_size, msg);
        return false;
    }
    if (r.status != 200) {
        set_err(err, err_size, error_message(r));
        return false;
    }
    return true;
}

bool mio_tpu_client_synthesize_to_wav(
        void * handle, const char * text, const char * reference_key,
        int32_t n_predict, const char * output_wav_path,
        char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c || !text || !reference_key || !output_wav_path) {
        set_err(err, err_size, "null argument");
        return false;
    }
    std::ostringstream j;
    j << "{\"text\": \"" << json_escape(text) << "\", \"reference_key\": \""
      << json_escape(reference_key) << "\"";
    append_params(*c, j, n_predict);
    j << "}";
    return synthesize_common(c, j.str(), output_wav_path, err, err_size);
}

bool mio_tpu_client_synthesize_codes_to_wav(
        void * handle, const int32_t * codes, size_t n_codes,
        const char * reference_key, const char * output_wav_path,
        char * err, size_t err_size) {
    auto * c = static_cast<Client *>(handle);
    if (!c || !codes || !n_codes || !reference_key || !output_wav_path) {
        set_err(err, err_size, "null argument");
        return false;
    }
    std::ostringstream j;
    j << "{\"codes\": [";
    for (size_t i = 0; i < n_codes; i++) {
        if (i) j << ", ";
        j << codes[i];
    }
    j << "], \"reference_key\": \"" << json_escape(reference_key) << "\"";
    append_params(*c, j, -1);
    j << "}";
    return synthesize_common(c, j.str(), output_wav_path, err, err_size);
}

void mio_tpu_string_free(char * str) {
    std::free(str);
}

}  // extern "C"
