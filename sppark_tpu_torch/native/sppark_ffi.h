// C-ABI vocabulary + linker-section symbol table for runtime-loaded modules.
//
// Role of the reference's go/cgo_sppark.h: user native sources WRAP their
// entry points, which places {fn, name} descriptors in a dedicated linker
// section `_sppark`; the loader (sppark_tpu/ffi/loader.py, the go_load
// analogue, go/sppark.go:66-136) walks __start__sppark..__stop__sppark via
// the exported sppark_symbols() enumerator and resolves each entry.
//
// The Error struct mirrors util/rusterror.h:18-36: returned BY VALUE, the
// message (if any) is strdup'd by the callee and freed by the caller
// (ffi/loader.py frees through libc, the TAKE_RESPONSIBILITY_FOR_ERROR_-
// MESSAGE contract of util/all_gpus.cpp:83-86).

#ifndef SPPARK_FFI_H
#define SPPARK_FFI_H

#include <stddef.h>
#include <string.h>
#include <stdlib.h>
#include <stdio.h>

#ifdef __cplusplus
#define SPPARK_EXTERN_C extern "C"
#else
#define SPPARK_EXTERN_C
#endif

typedef struct {
    int code;
    char *message;   // strdup'd; caller frees (NULL when code == 0)
} sppark_Error;

static inline sppark_Error sppark_ok(void)
{
    sppark_Error e; e.code = 0; e.message = NULL; return e;
}

static inline sppark_Error sppark_err(int code, const char *msg)
{
    sppark_Error e; e.code = code; e.message = msg ? strdup(msg) : NULL;
    return e;
}

typedef struct {
    void *fn;
    const char *name;
} sppark_entry;

// WRAP(fn): register an already-declared extern "C" symbol in the module's
// `_sppark` section (cgo_sppark.h's WRAP/WRAP_ERR play this role; the
// Go-thunk half is unnecessary under ctypes, which calls by address).
#define SPPARK_WRAP(fn)                                                     \
    static sppark_entry __sppark_e_##fn                                     \
        __attribute__((used, section("_sppark"), aligned(sizeof(void *))))  \
        = {(void *)(fn), #fn};

extern sppark_entry __start__sppark[] __attribute__((weak));
extern sppark_entry __stop__sppark[] __attribute__((weak));

// Enumerator the loader resolves first; weak so that a module composed of
// several TUs including this header still links.
SPPARK_EXTERN_C __attribute__((weak)) sppark_entry *
sppark_symbols(size_t *count)
{
    if (!__start__sppark) { *count = 0; return NULL; }
    *count = (size_t)(__stop__sppark - __start__sppark);
    return __start__sppark;
}

// Message disposal export (drop_error_message, util/all_gpus.cpp:83-86).
SPPARK_EXTERN_C __attribute__((weak)) void
sppark_drop_error_message(char *msg)
{
    free(msg);
}

#endif  // SPPARK_FFI_H
