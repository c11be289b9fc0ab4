// SLAM host runtime: the C++ pieces of the I/O plane.
//
// Capability parity with the reference's native runtime layer:
//  - PNG decode for the KITTI loader (reference uses cv::imread,
//    src/kittirunner.cpp:108-134) via libpng, grayscale float32 output.
//  - cluon-compatible POSIX SharedMemory client (reference:
//    include/cluon-complete-v0.0.77.hpp:8067-8141: header = uint32 size +
//    pthread_mutex_t + pthread_cond_t, robust shared attributes) so this
//    engine can attach to frames published by an unmodified OpenDLV camera
//    proxy (ingest loop reference: src/opendlv-perception-vision-orbslam2.cpp:78-106).
//  - UDP multicast sender for OD4 envelopes (reference: OD4Session send path)
//    so pose/map publishing does not round-trip through Python sockets.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 dependency).

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <png.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decoding (grayscale float32)
// ---------------------------------------------------------------------------

// Returns 0 on success; fills width/height. Caller provides a buffer of
// capacity cap_bytes; required size is width*height*sizeof(float).
int png_decode_gray(const char *path, float *out, int64_t cap_bytes,
                    int32_t *width, int32_t *height) {
    FILE *fp = fopen(path, "rb");
    if (!fp) return -1;

    png_byte header[8];
    if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
        fclose(fp);
        return -2;
    }
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (!png || !info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return -3;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);

    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);

    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_PALETTE)
        png_set_rgb_to_gray_fixed(png, 1, -1, -1);
    png_read_update_info(png, info);

    if ((int64_t)w * h * (int64_t)sizeof(float) > cap_bytes) {
        png_destroy_read_struct(&png, &info, nullptr);
        fclose(fp);
        return -4;
    }

    png_bytep row = (png_bytep)malloc(png_get_rowbytes(png, info));
    for (png_uint_32 y = 0; y < h; ++y) {
        png_read_row(png, row, nullptr);
        float *dst = out + (int64_t)y * w;
        for (png_uint_32 x = 0; x < w; ++x) dst[x] = (float)row[x];
    }
    free(row);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    *width = (int32_t)w;
    *height = (int32_t)h;
    return 0;
}

// ---------------------------------------------------------------------------
// cluon-compatible POSIX SharedMemory client
// ---------------------------------------------------------------------------

struct SharedMemoryHeader {  // exact layout of cluon's header (ref :8134-8138)
    uint32_t size;
    pthread_mutex_t mutex;
    pthread_cond_t condition;
};

struct ShmHandle {
    int fd;
    void *base;
    SharedMemoryHeader *header;
    uint8_t *data;
    uint32_t size;
};

void *shm_attach(const char *name) {
    char buf[256];
    if (name[0] != '/') snprintf(buf, sizeof(buf), "/%s", name);
    else snprintf(buf, sizeof(buf), "%s", name);

    int fd = shm_open(buf, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    void *base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                      MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { close(fd); return nullptr; }

    auto *h = new ShmHandle;
    h->fd = fd;
    h->base = base;
    h->header = (SharedMemoryHeader *)base;
    h->data = (uint8_t *)base + sizeof(SharedMemoryHeader);
    h->size = h->header->size;
    return h;
}

uint32_t shm_size(void *handle) { return ((ShmHandle *)handle)->size; }

void shm_lock(void *handle) {
    auto *h = (ShmHandle *)handle;
    if (pthread_mutex_lock(&h->header->mutex) == EOWNERDEAD) {
        // robust mutex: previous owner died; make state consistent
        pthread_mutex_consistent(&h->header->mutex);
    }
}

void shm_unlock(void *handle) {
    auto *h = (ShmHandle *)handle;
    pthread_mutex_unlock(&h->header->mutex);
}

void shm_wait(void *handle) {
    auto *h = (ShmHandle *)handle;
    pthread_mutex_lock(&h->header->mutex);
    pthread_cond_wait(&h->header->condition, &h->header->mutex);
    pthread_mutex_unlock(&h->header->mutex);
}

// Copy the current frame under the lock; returns bytes copied.
int64_t shm_read(void *handle, uint8_t *out, int64_t cap) {
    auto *h = (ShmHandle *)handle;
    int64_t n = h->size < cap ? h->size : cap;
    shm_lock(handle);
    memcpy(out, h->data, (size_t)n);
    shm_unlock(handle);
    return n;
}

void shm_detach(void *handle) {
    auto *h = (ShmHandle *)handle;
    munmap(h->base, h->size + sizeof(SharedMemoryHeader));
    close(h->fd);
    delete h;
}

// ---------------------------------------------------------------------------
// UDP multicast sender (OD4 envelope transport)
// ---------------------------------------------------------------------------

struct UdpHandle {
    int fd;
    sockaddr_in addr;
};

void *udp_multicast_open(const char *group, uint16_t port) {
    int fd = socket(AF_INET, SOCK_DGRAM, IPPROTO_UDP);
    if (fd < 0) return nullptr;
    uint8_t ttl = 1;
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));
    auto *h = new UdpHandle;
    h->fd = fd;
    memset(&h->addr, 0, sizeof(h->addr));
    h->addr.sin_family = AF_INET;
    h->addr.sin_port = htons(port);
    inet_pton(AF_INET, group, &h->addr.sin_addr);
    return h;
}

int64_t udp_send(void *handle, const uint8_t *data, int64_t len) {
    auto *h = (UdpHandle *)handle;
    return sendto(h->fd, data, (size_t)len, 0, (sockaddr *)&h->addr,
                  sizeof(h->addr));
}

void udp_close(void *handle) {
    auto *h = (UdpHandle *)handle;
    close(h->fd);
    delete h;
}

}  // extern "C"
