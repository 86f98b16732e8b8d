# Container image: daemon + dyno CLI + python client in one deployable
# unit (reference ships a build-repro Dockerfile: /Dockerfile there; this
# one targets deployment on TPU-VM hosts/k8s DaemonSets too).
#
#   docker build -t dynolog-tpu .
#   docker run --net=host --pid=host \
#     -v /proc:/host/proc -v /sys:/host/sys -v /dev:/host/dev \
#     dynolog-tpu --procfs_root /host
#
# --pid=host + mounted /host{proc,sys,dev} let the containerized daemon
# see the host's processes, NUMA topology, and TPU chips (sysfs accel
# class plus the /dev/accelN and /dev/vfio discovery fallbacks) through
# the same injectable-root seam the tests use.

FROM ubuntu:24.04 AS build
RUN apt-get update && apt-get install -y --no-install-recommends \
    cmake ninja-build g++ && rm -rf /var/lib/apt/lists/*
WORKDIR /src
COPY native/ native/
RUN cmake -S native -B native/build -G Ninja -DCMAKE_BUILD_TYPE=Release \
    && ninja -C native/build dynolog_tpu_daemon dyno

FROM ubuntu:24.04
RUN apt-get update && apt-get install -y --no-install-recommends \
    python3 && rm -rf /var/lib/apt/lists/*
COPY --from=build /src/native/build/dynolog_tpu_daemon /usr/local/bin/
COPY --from=build /src/native/build/dyno /usr/local/bin/
COPY dynolog_tpu/ /usr/lib/python3/dist-packages/dynolog_tpu/
# The PyTorch port: no torch in the image, so it serves the fleet tools
COPY dynolog_tpu_torch/ /usr/lib/python3/dist-packages/dynolog_tpu_torch/
# RPC control plane (dyno CLI) + Prometheus exposer.
EXPOSE 1778 8081
ENTRYPOINT ["/usr/local/bin/dynolog_tpu_daemon"]
