#!/bin/bash
# Run the test suite once under each CPU instruction-set setting that XLA
# and ATen can be held to, and list the tests that fail under each.
#
# The port's parity tests compare float sums of two libraries; which way a
# near-tie falls depends on the vector width each library picks on the
# machine at hand. A parity test is committed only if it passes under
# every setting here.
#
#   scripts/parity_sweep.sh [OUT_DIR] [SETTING ...] [-- PYTEST_PATHS ...]
#
# OUT_DIR defaults to build/parity_sweep (ignored by git). SETTINGs are
# the names below (default: all of them); PYTEST_PATHS default to tests/.
# Each run takes the tier-1 command's flags (-n 6 --dist loadfile) and
# writes OUT_DIR/<setting>.log and .xml; OUT_DIR/summary.txt gets one line
# per setting (exit code, seconds, pytest's last line, failing tests).
set -u
cd "$(dirname "$0")/.."
out=${1:-build/parity_sweep}
[ $# -gt 0 ] && shift
settings=()
while [ $# -gt 0 ] && [ "$1" != "--" ]; do settings+=("$1"); shift; done
[ $# -gt 0 ] && shift
paths=("$@")
[ ${#paths[@]} -eq 0 ] && paths=(tests/)
[ ${#settings[@]} -eq 0 ] && settings=(default xla_sse42 xla_avx xla_avx2
    aten_default aten_avx2 aten_avx512 xla_sse42+aten_default)

env_of() {
    case $1 in
        default) echo "";;
        xla_sse42) echo "XLA_FLAGS=--xla_cpu_max_isa=SSE4_2";;
        xla_avx) echo "XLA_FLAGS=--xla_cpu_max_isa=AVX";;
        xla_avx2) echo "XLA_FLAGS=--xla_cpu_max_isa=AVX2";;
        aten_default) echo "ATEN_CPU_CAPABILITY=default";;
        aten_avx2) echo "ATEN_CPU_CAPABILITY=avx2";;
        aten_avx512) echo "ATEN_CPU_CAPABILITY=avx512";;
        xla_sse42+aten_default)
            echo "XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 ATEN_CPU_CAPABILITY=default";;
        *) echo "unknown setting: $1" >&2; return 1;;
    esac
}

mkdir -p "$out"
rc_all=0
for s in "${settings[@]}"; do
    e=$(env_of "$s") || exit 2
    t0=$(date +%s)
    # shellcheck disable=SC2086
    timeout -k 10 1470 env JAX_PLATFORMS=cpu ALLOW_MULTIPLE_LIBTPU_LOAD=1 $e \
        python -m pytest "${paths[@]}" -q -m 'not slow' \
        --continue-on-collection-errors -p no:cacheprovider -p xdist -n 6 \
        --dist loadfile --junitxml="$out/$s.xml" -p no:randomly \
        > "$out/$s.log" 2>&1
    rc=$?
    [ $rc -ne 0 ] && rc_all=1
    failed=$(grep -aE '^(FAILED|ERROR) ' "$out/$s.log" | cut -d' ' -f2 |
             tr '\n' ' ')
    echo "$s rc=$rc secs=$(( $(date +%s) - t0 )) $(tail -n 1 "$out/$s.log")" \
         "failed: ${failed:-none}" | tee -a "$out/summary.txt"
done
exit $rc_all
