#!/usr/bin/env bash
# Build the native ingestion helpers into libmsm_native.so, or into the
# path given as the first argument.
set -euo pipefail
OUT="$(realpath -m "${1:-$(dirname "$0")/libmsm_native.so}")"
cd "$(dirname "$0")"
# -march=native: the library is always (re)built on the machine that uses
# it (ingest.native.build()), so host-specific SIMD is safe.
g++ -O3 -march=native -fPIC -shared -std=c++17 -o "$OUT" \
    src/msm_native.cpp src/jsonl_emit.cpp src/jpeg_encode.cpp \
    src/jpeg_codec.cpp \
    -lz -lpthread
echo "built $OUT"
