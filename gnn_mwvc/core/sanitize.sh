#!/bin/bash
# Sanitizer builds + test run for the native core (SURVEY.md §5 "race
# detection": the reference ships none; we gate the C++ core on ASan/UBSan).
# Usage: bash gnn_mwvc/core/sanitize.sh [asan|ubsan|tsan]
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
MODE=${1:-asan}
case "$MODE" in
  asan)  FLAGS="-fsanitize=address -fno-omit-frame-pointer" ;;
  ubsan) FLAGS="-fsanitize=undefined -fno-omit-frame-pointer" ;;
  tsan)  FLAGS="-fsanitize=thread" ;;
  *) echo "unknown mode $MODE"; exit 1 ;;
esac

OUT=$(mktemp -d)/libmwvc_core_${MODE}.so
g++ -std=c++17 -O1 -g -fPIC -shared $FLAGS -o "$OUT" "$HERE/src/capi.cpp"
echo "built $OUT"

# Run the core test suite against the sanitized library.  ASan must be
# preloaded because python itself is uninstrumented.
PRELOAD=""
if [ "$MODE" = "asan" ]; then
  PRELOAD=$(g++ -print-file-name=libasan.so)
elif [ "$MODE" = "ubsan" ]; then
  PRELOAD=$(g++ -print-file-name=libubsan.so)
elif [ "$MODE" = "tsan" ]; then
  PRELOAD=$(g++ -print-file-name=libtsan.so)
fi

cd "$HERE/../.."
LD_PRELOAD="$PRELOAD" MWVC_CORE_LIB="$OUT" \
  ASAN_OPTIONS=detect_leaks=0 \
  python -m pytest tests/test_core.py tests/test_baselines.py -x -q
