/* mio_tpu_client — C ABI client bridge for the miotts server (the port's
 * copy of miotts_tpu/bindings/native/mio_tpu_client.h, the same ABI).
 *
 * Capability-parity redesign of the reference's mobile bridges
 * (examples/swiftui/.../MioTTSLocalBridge.h:11-92 and
 * examples/android/.../mio_tts_android_jni.cpp:73-425): those shims wrap an
 * on-device inference engine; here the models live behind the HTTP server
 * (miotts_tpu_torch/serving/server.py, on the GPU), so the bridge an
 * iOS/Android/desktop app links against is a thin client
 * with the same function surface (create/destroy, generation params,
 * reference lifecycle, text->wav, codes->wav). Plain POSIX sockets,
 * HTTP/1.1, zero external dependencies.
 *
 * Every function returns true on success; on failure a human-readable
 * message is written to (err, err_size). Strings returned through `char **`
 * must be released with mio_tpu_string_free().
 */
#pragma once

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* base_url: "http://host:port". Probes GET /health once. */
void * mio_tpu_client_create(const char * base_url, char * err, size_t err_size);
void   mio_tpu_client_destroy(void * handle);

/* Defaults applied to subsequent synthesize calls (server defaults when a
 * value is negative / zero where invalid). */
bool mio_tpu_client_set_generation_params(
        void * handle, int32_t n_predict, int32_t top_k, float top_p,
        float temp, float repeat_penalty, int32_t seed,
        char * err, size_t err_size);

bool mio_tpu_client_health_json(
        void * handle, char ** json_out, char * err, size_t err_size);

bool mio_tpu_client_list_references_json(
        void * handle, char ** json_out, char * err, size_t err_size);

/* Uploads a local audio file (WAV, FLAC or mp3: the server decodes it) and
 * registers the speaker reference under
 * `reference_key`; optionally stores the returned .emb.gguf at
 * embedding_out_path (pass NULL to skip). */
bool mio_tpu_client_create_reference_from_audio(
        void * handle, const char * reference_key, const char * audio_path,
        float max_reference_seconds, const char * embedding_out_path,
        char * err, size_t err_size);

/* Uploads a local .emb.gguf and registers it under `reference_key`. */
bool mio_tpu_client_add_reference_from_gguf(
        void * handle, const char * reference_key, const char * embedding_path,
        char * err, size_t err_size);

bool mio_tpu_client_remove_reference(
        void * handle, const char * reference_key, char * err, size_t err_size);

/* text -> 16-bit PCM WAV written to output_wav_path.
 * n_predict <= 0 uses the params set via set_generation_params (or server
 * default). */
bool mio_tpu_client_synthesize_to_wav(
        void * handle, const char * text, const char * reference_key,
        int32_t n_predict, const char * output_wav_path,
        char * err, size_t err_size);

/* Mio audio codes -> WAV (bypasses the LLM). */
bool mio_tpu_client_synthesize_codes_to_wav(
        void * handle, const int32_t * codes, size_t n_codes,
        const char * reference_key, const char * output_wav_path,
        char * err, size_t err_size);

void mio_tpu_string_free(char * str);

#ifdef __cplusplus
}
#endif
