# Dev container for php_aho_corasick_tpu (reference analog: the upstream
# Ubuntu+php-dev image, reference Dockerfile:39-46 + docker/*.sh helpers).
#
# CPU-only: tests run on a simulated 8-device mesh (tests/conftest.py pins
# XLA_FLAGS/JAX_PLATFORMS).  The GPU path (chip_smoke.py, bench.py) needs
# JAX with its CUDA plugin on a machine with an NVIDIA GPU; both scripts
# fail without one.
#
#   docker build -t php-ac .
#   docker build --build-arg DEVEL_TOOLS=1 -t php-ac-dev .  # + gdb/valgrind
#   docker run --rm php-ac                      # run the test suite

FROM python:3.11-slim

ARG DEVEL_TOOLS=0
RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make \
    && if [ "$DEVEL_TOOLS" = "1" ]; then \
         apt-get install -y --no-install-recommends gdb valgrind; \
       fi \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/php_aho_corasick_tpu
COPY pyproject.toml README.md ./
COPY php_aho_corasick_tpu ./php_aho_corasick_tpu
COPY tests ./tests
COPY benchmarks ./benchmarks
COPY examples ./examples
COPY bench.py chip_smoke.py ./

RUN pip install --no-cache-dir "jax[cpu]" numpy pytest && pip install --no-cache-dir -e .

# build the native builder/oracle once at image build (ctypes .so).  A
# failed native build is non-fatal (tests fall back to the pure-Python
# builder) but must be LOUD: native-oracle test coverage silently degrades.
RUN make -C php_aho_corasick_tpu/native \
    || echo >&2 "WARNING: native build FAILED - tests will run WITHOUT the C++ builder/oracle (degraded coverage)"

ENV JAX_PLATFORMS=cpu
CMD ["python", "-m", "pytest", "tests/", "-q"]
