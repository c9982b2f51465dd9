/* fdbtpu_c.h — the C ABI of the tpu-kv client.
 *
 * Reference: REF:bindings/c/foundationdb/fdb_c.h — every language binding
 * goes through this surface.  It is the synchronous core of that API
 * (get/set/clear, range reads, atomics, read versions, options, commit
 * and on_error with the standard retry-loop contract); it has no futures
 * or callbacks.  The PyTorch/CUDA port keeps the same symbols as the JAX
 * package's library, so a program built against one links against the
 * other.
 *
 * Thread model: fdbtpu_init() starts the network (an embedded client
 * runtime on its own thread, the run_network analog); every call below is
 * thread-safe and blocking.  Returned buffers are owned by the caller and
 * released with fdbtpu_free().
 */

#ifndef FDBTPU_C_H
#define FDBTPU_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int fdbtpu_error_t;            /* 0 = success; FDB error codes */

typedef struct FDBTPUTransaction FDBTPUTransaction;

/* Start the client network against the given cluster file.  Returns 0 or
 * an error code.  Call once per process. */
fdbtpu_error_t fdbtpu_init(const char* cluster_file_path);

/* Stop the network and release the runtime. */
fdbtpu_error_t fdbtpu_stop(void);

/* Create / destroy a transaction. */
fdbtpu_error_t fdbtpu_create_transaction(FDBTPUTransaction** out);
void fdbtpu_transaction_destroy(FDBTPUTransaction* tr);

/* Reads.  On success *out_present tells whether the key exists; when it
 * does, *out_value/*out_length hold a malloc'd copy (fdbtpu_free it). */
fdbtpu_error_t fdbtpu_transaction_get(FDBTPUTransaction* tr,
                                      const uint8_t* key, int key_length,
                                      int* out_present,
                                      uint8_t** out_value, int* out_length);

/* Buffered writes (visible to this transaction's reads, RYW). */
fdbtpu_error_t fdbtpu_transaction_set(FDBTPUTransaction* tr,
                                      const uint8_t* key, int key_length,
                                      const uint8_t* value, int value_length);
fdbtpu_error_t fdbtpu_transaction_clear(FDBTPUTransaction* tr,
                                        const uint8_t* key, int key_length);

/* Range read.  On success *out_buf holds count records packed as
 * ([u32 key_length][key][u32 value_length][value]) * count, little
 * endian, in one malloc'd buffer (fdbtpu_free it).  limit 0 = no limit;
 * reverse != 0 returns descending order. */
fdbtpu_error_t fdbtpu_transaction_get_range(FDBTPUTransaction* tr,
                                            const uint8_t* begin,
                                            int begin_length,
                                            const uint8_t* end,
                                            int end_length,
                                            int limit, int reverse,
                                            uint8_t** out_buf,
                                            int* out_length,
                                            int* out_count);

/* Atomic read-modify-write (FDBMutationType opcodes: ADD=2, BIT_AND=6,
 * BIT_OR=7, BIT_XOR=8, APPEND_IF_FITS=9, MAX=12, MIN=13,
 * SET_VERSIONSTAMPED_KEY=14, SET_VERSIONSTAMPED_VALUE=15, BYTE_MIN=16,
 * BYTE_MAX=17 — values match fdb_c.h where an equivalent exists). */
fdbtpu_error_t fdbtpu_transaction_atomic_op(FDBTPUTransaction* tr, int op,
                                            const uint8_t* key,
                                            int key_length,
                                            const uint8_t* operand,
                                            int operand_length);

/* The transaction's read version (GRV). */
fdbtpu_error_t fdbtpu_transaction_get_read_version(FDBTPUTransaction* tr,
                                                   int64_t* out_version);

/* Named transaction option ("lock_aware", ...).  Unknown options return
 * error 2007 (invalid_option). */
fdbtpu_error_t fdbtpu_transaction_set_option(FDBTPUTransaction* tr,
                                             const char* option);

/* Commit; on success *out_committed_version holds the commit version. */
fdbtpu_error_t fdbtpu_transaction_commit(FDBTPUTransaction* tr,
                                         int64_t* out_committed_version);

/* The retry-loop contract: feed a failed call's error code back; returns
 * 0 when the transaction was reset and should be retried, else the
 * (non-retryable) error to surface. */
fdbtpu_error_t fdbtpu_transaction_on_error(FDBTPUTransaction* tr,
                                           fdbtpu_error_t code);

/* Reset a transaction for reuse. */
fdbtpu_error_t fdbtpu_transaction_reset(FDBTPUTransaction* tr);

void fdbtpu_free(uint8_t* ptr);

/* Static description of an error code (never NULL). */
const char* fdbtpu_get_error(fdbtpu_error_t code);

#ifdef __cplusplus
}
#endif
#endif /* FDBTPU_C_H */
