// Sequence packer: EOS-delimited documents -> fixed [batch, seq] grids.
//
// The native data-loader of the training input pipeline (the reference
// keeps its loaders native too — SURVEY §2.11). Padding is what kills
// input-bound MFU: greedy first-fit packing fills each row of the batch
// with as many whole documents as fit, emitting per-token segment ids
// (1-based; 0 = padding) and intra-document positions so attention and
// RoPE treat packed neighbours as separate sequences.
//
// The PyTorch port's copy of addons/dataloader/packer.cc, the same code.
// Pure C ABI, built by skypilot_tpu_torch/_build.py with the host C++
// compiler and called via ctypes from skypilot_tpu_torch/data/packer.py
// (whose pack_batch_py mirrors it bit for bit for CPU runs without a
// compiler). Single pass, no allocation, no locks: ~memory-bandwidth speed.
//
// Semantics (mirrored EXACTLY by pack_batch_py; the parity test asserts
// bit-equality):
//   * Documents are maximal EOS-terminated runs; the EOS belongs to its
//     document. A trailing run without EOS is a document too.
//   * Documents longer than `seq` are split into seq-sized chunks
//     (each chunk its own segment; positions restart).
//   * Chunks are placed greedily into the first row with room,
//     starting at the row that received the previous chunk (first-fit
//     with rotating start keeps rows balanced without a second pass).
//   * Packing stops when every row is full, or no remaining chunk fits
//     anywhere, or tokens are exhausted. *out_next is the offset of the
//     first token NOT consumed.

#include <cstdint>

extern "C" {

// Returns the number of tokens placed into the grid (0 => nothing
// packed: caller is at end of data).
long skyt_pack_batch(const uint32_t* tokens, long n_tokens, long start,
                     uint32_t eos_id, int batch, int seq,
                     uint32_t* out_tokens,   // [batch*seq], pre-zeroed ok
                     int32_t* out_segments,  // [batch*seq]
                     int32_t* out_positions, // [batch*seq]
                     long* out_next) {
    for (long i = 0; i < (long)batch * seq; ++i) {
        out_tokens[i] = 0;
        out_segments[i] = 0;
        out_positions[i] = 0;
    }
    // fill[r] = tokens already placed in row r; seg[r] = segments in r.
    // batch is operator-controlled and small; a fixed cap keeps the ABI
    // allocation-free.
    const int kMaxBatch = 4096;
    if (batch > kMaxBatch || batch <= 0 || seq <= 0) {
        *out_next = start;
        return -1;
    }
    long fill[kMaxBatch];
    int32_t seg[kMaxBatch];
    for (int r = 0; r < batch; ++r) {
        fill[r] = 0;
        seg[r] = 0;
    }

    long offset = start;
    long placed = 0;
    int row_hint = 0;
    while (offset < n_tokens) {
        // Next document chunk: up to seq tokens, ending at EOS or cap.
        long doc_len = 0;
        while (offset + doc_len < n_tokens && doc_len < seq) {
            ++doc_len;
            if (tokens[offset + doc_len - 1] == eos_id) break;
        }
        if (doc_len == 0) break;
        // First row with room, starting from the hint.
        int row = -1;
        for (int probe = 0; probe < batch; ++probe) {
            int r = (row_hint + probe) % batch;
            if (fill[r] + doc_len <= seq) {
                row = r;
                break;
            }
        }
        if (row < 0) break;  // nothing fits anywhere: batch is done
        uint32_t* trow = out_tokens + (long)row * seq + fill[row];
        int32_t* srow = out_segments + (long)row * seq + fill[row];
        int32_t* prow = out_positions + (long)row * seq + fill[row];
        int32_t segment = ++seg[row];
        for (long i = 0; i < doc_len; ++i) {
            trow[i] = tokens[offset + i];
            srow[i] = segment;
            prow[i] = (int32_t)i;
        }
        fill[row] += doc_len;
        placed += doc_len;
        offset += doc_len;
        row_hint = row;
        // All rows full?
        bool full = true;
        for (int r = 0; r < batch; ++r) {
            if (fill[r] < seq) {
                full = false;
                break;
            }
        }
        if (full) break;
    }
    *out_next = offset;
    return placed;
}

}  // extern "C"
