# Production image for ptmcmcsampler-tpu (mirrors the reference's Dockerfile
# role).
FROM python:3.12-slim AS base

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY ptmcmcsampler_tpu ./ptmcmcsampler_tpu
COPY csrc ./csrc

# CPU JAX by default; on an NVIDIA GPU host install JAX's CUDA build of the
# same version instead (jax[cuda12]).
RUN pip install --no-cache-dir . && \
    python -m ptmcmcsampler_tpu.io.build_native

FROM base AS dev
COPY tests ./tests
COPY examples ./examples
COPY bench.py Makefile pytest.ini ./
RUN pip install --no-cache-dir pytest scipy

CMD ["python", "-c", "import ptmcmcsampler_tpu; print(ptmcmcsampler_tpu.__version__)"]
