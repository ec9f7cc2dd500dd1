// Native entropy-decode hot loop: a line-for-line port of the Python
// 16-bit-peek LUT scan decoder in ops/jpeg_device._decode_scan.
//
// The port's own copy of keystone_tpu/native/entropy.cpp (same code, same
// error codes).  The device-resident decode path (ops/jpeg_device.py)
// splits baseline JPEG at the entropy boundary; its host half, the Huffman
// scan decode, is the only O(compressed-bytes) loop on the host, and in
// pure Python it takes about 0.1 s for one 500x375 image.  This
// translation unit runs that loop natively, under an exacting contract:
//
//   * BIT-IDENTICAL coefficient planes: everything that shapes the output
//     — header parsing, Huffman LUT compilation, restart-segment
//     splitting/unstuffing, plane allocation — stays in the SAME Python
//     code (ops/jpeg_device.entropy_decode); only the O(compressed-bytes)
//     symbol loop runs here, writing into the caller's int16 planes with
//     the same zigzag scatter and the same DC prediction.
//   * IDENTICAL typed-error classification: every corrupt-stream check
//     the Python loop performs exists here at the same point in the same
//     order, returned as a KST_E* code that ops/native_entropy.py maps
//     back onto the exact JpegEntropyCorrupt message the Python pass
//     raises.  A stream that fails at MCU k in Python fails at MCU k
//     here with the same classification — the decoders are
//     indistinguishable from the stream contract's point of view.
//
// The function is reentrant and touches no globals, so the ingest thread
// pool drives one call per image across cores; ctypes releases the GIL
// for the duration of each call (the whole point — the Python loop held
// it for the entire scan).
//
// Build: g++ -O2 -shared -fPIC, by keystone_tpu_torch/_build.py into
// build/kernels/entropy-<hash>.so at first use (ops/native_entropy.py);
// deliberately NO libjpeg dependency — only a C++ compiler is needed.

extern "C" {

// Error codes — each maps 1:1 onto a JpegEntropyCorrupt message in
// ops/native_entropy.py (keep the two tables in sync).
enum {
  KST_EOK = 0,
  KST_EINVALID_CODE = 1,   // invalid Huffman code or truncated scan
  KST_EZRL_OVERFLOW = 2,   // ZRL overflows the block
  KST_EAC_OVERFLOW = 3,    // AC run overflows the block
  KST_EDC_CATEGORY = 4,    // DC category out of range
  KST_ETRUNC_COEFF = 5,    // truncated scan mid-coefficient
  KST_EDC_RANGE = 6,       // DC predictor out of int16 range
  KST_ETRUNCATED = 7,      // decoded fewer MCUs than the geometry needs
};

// Decode every MCU of an (already unstuffed, restart-split) scan into the
// caller's per-component coefficient planes.
//
//   segs / seg_lens / nseg   restart segments (stuffing already removed)
//   planes                   per-component int16 plane base pointers,
//                            laid out [block_row][row_width][64]
//   row_width                per-component blocks per plane row
//   mcu_blocks               n_mcu_blocks rows of 7 ints:
//                            (comp, v, h, block_y, block_x, dc_lut, ac_lut)
//   lut_len / lut_sym        per-LUT 65536-entry 16-bit-peek tables
//                            (code length / symbol), indexed by the
//                            mcu_blocks LUT columns
//   zigzag                   64-entry zigzag->natural position table
//   err_info                 out[2]: failing MCU index / DC category
//
// Returns KST_EOK or the KST_E* classification of the damage.
int kst_entropy_decode(
    const unsigned char* const* segs, const long long* seg_lens, int nseg,
    short* const* planes, const int* row_width,
    const int* mcu_blocks, int n_mcu_blocks,
    const unsigned char* const* lut_len,
    const unsigned char* const* lut_sym,
    const unsigned char* zigzag,
    int ncomp, long long mcus_x, long long total_mcus, long long interval,
    long long* err_info) {
  long long preds[4];  // baseline frames carry at most 3 components
  long long mcu = 0;
  for (int s = 0; s < nseg; ++s) {
    const unsigned char* seg = segs[s];
    const long long nbytes = seg_lens[s];
    // Bit reader as plain locals, exactly the Python loop's acc/accbits/
    // pos.  Worst-case accumulator occupancy is 15 held bits + a 6-byte
    // refill = 63 bits, so uint64 never overflows.
    unsigned long long acc = 0;
    int accbits = 0;
    long long pos = 0;
    for (int c = 0; c < ncomp; ++c) preds[c] = 0;
    long long seg_end = mcu + interval;
    if (seg_end > total_mcus) seg_end = total_mcus;
    while (mcu < seg_end) {
      const long long my = mcu / mcus_x;
      const long long mx = mcu % mcus_x;
      for (int b = 0; b < n_mcu_blocks; ++b) {
        const int* mb = mcu_blocks + 7 * b;
        const int ci = mb[0];
        short* row = planes[ci] +
            ((my * mb[1] + mb[3]) * (long long)row_width[ci] +
             mx * mb[2] + mb[4]) * 64;
        long long pred = preds[ci];
        const unsigned char* lenb = lut_len[mb[5]];
        const unsigned char* symb = lut_sym[mb[5]];
        int ac = 0;
        int k = 0;
        for (;;) {
          // -- decode one Huffman symbol --------------------------------
          if (accbits < 16 && pos < nbytes) {
            const long long rem = nbytes - pos;
            const int take = rem < 6 ? (int)rem : 6;
            for (int t = 0; t < take; ++t) acc = (acc << 8) | seg[pos + t];
            accbits += 8 * take;
            pos += take;
          }
          const unsigned peek = (unsigned)(
              (accbits < 16 ? (acc << (16 - accbits))
                            : (acc >> (accbits - 16))) & 0xFFFFu);
          const int nb = lenb[peek];
          if (nb == 0 || nb > accbits) {
            err_info[0] = mcu;
            return KST_EINVALID_CODE;
          }
          accbits -= nb;
          acc &= (1ULL << accbits) - 1;
          const int sym = symb[peek];
          // -- interpret it ---------------------------------------------
          int size;
          if (ac) {
            const int run = sym >> 4;
            size = sym & 0xF;
            if (size == 0) {
              if (run == 15) {
                k += 16;
                if (k > 63) return KST_EZRL_OVERFLOW;
                continue;
              }
              break;  // EOB
            }
            k += run + 1;
            if (k > 63) return KST_EAC_OVERFLOW;
          } else {
            size = sym;
            if (size > 15) {
              err_info[1] = size;
              return KST_EDC_CATEGORY;
            }
          }
          // -- receive the value bits -----------------------------------
          long long val = 0;
          if (size) {
            if (accbits < size) {
              const long long rem = nbytes - pos;
              const int take = rem < 6 ? (rem > 0 ? (int)rem : 0) : 6;
              for (int t = 0; t < take; ++t) acc = (acc << 8) | seg[pos + t];
              accbits += 8 * take;
              pos += take;
              if (accbits < size) return KST_ETRUNC_COEFF;
            }
            accbits -= size;
            val = (long long)((acc >> accbits) & ((1ULL << size) - 1));
            acc &= (1ULL << accbits) - 1;
            if (val < (1LL << (size - 1))) val = val - (1LL << size) + 1;
          }
          if (ac) {
            row[zigzag[k]] = (short)val;
            if (k == 63) break;
          } else {
            pred += val;
            if (pred < -32768 || pred > 32767) return KST_EDC_RANGE;
            row[0] = (short)pred;
            ac = 1;
            lenb = lut_len[mb[6]];
            symb = lut_sym[mb[6]];
          }
        }
        preds[ci] = pred;
      }
      mcu += 1;
    }
  }
  if (mcu != total_mcus) {
    err_info[0] = mcu;
    return KST_ETRUNCATED;
  }
  return KST_EOK;
}

}  // extern "C"
