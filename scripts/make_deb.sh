#!/usr/bin/env bash
# Builds an installable .deb: daemon + dyno CLI + systemd unit +
# logrotate + flagfile + the Python client/fleet packages (JAX and
# PyTorch).
# (reference: scripts/debian/{control,make_deb.sh})
#
# Usage: scripts/make_deb.sh [outdir]   (default: dist/)
set -euo pipefail
cd "$(dirname "$0")/.."

OUT=${1:-dist}
VERSION=$(sed -n 's/.*kVersion = "\(.*\)".*/\1/p' native/src/common/Version.h)
ARCH=$(dpkg --print-architecture 2>/dev/null || echo amd64)
PKG=dynolog-tpu_${VERSION}_${ARCH}
STAGE=$(mktemp -d)
trap 'rm -rf "$STAGE"' EXIT

# Binaries must exist (CI builds first; local: scripts/build.sh).
test -x native/build/dynolog_tpu_daemon || ./scripts/build.sh
install -D -m755 native/build/dynolog_tpu_daemon \
    "$STAGE/$PKG/usr/local/bin/dynolog_tpu_daemon"
install -D -m755 native/build/dyno "$STAGE/$PKG/usr/local/bin/dyno"
install -D -m644 scripts/dynolog-tpu.service \
    "$STAGE/$PKG/lib/systemd/system/dynolog-tpu.service"
install -D -m644 scripts/dynolog-tpu.logrotate \
    "$STAGE/$PKG/etc/logrotate.d/dynolog-tpu"

# Default flagfile — single checked-in source shared with make_rpm.sh
# (conffile: dpkg preserves operator edits on upgrade).
install -D -m644 scripts/dynolog_tpu.flags \
    "$STAGE/$PKG/etc/dynolog_tpu.flags"

# The Python client + fleet packages, importable system-wide: the JAX
# package and its PyTorch port (torch comes from the job's environment).
PYDIR="$STAGE/$PKG/usr/lib/python3/dist-packages"
for pkg in dynolog_tpu dynolog_tpu_torch; do
    mkdir -p "$PYDIR/$pkg"
    cp -r "$pkg"/* "$PYDIR/$pkg/"
done
find "$PYDIR" -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true

mkdir -p "$STAGE/$PKG/DEBIAN"
cat > "$STAGE/$PKG/DEBIAN/control" <<EOF
Package: dynolog-tpu
Version: $VERSION
Architecture: $ARCH
Maintainer: dynolog-tpu maintainers
Section: admin
Priority: optional
Depends: libc6, libstdc++6, libgcc-s1
Recommends: python3
Description: Always-on TPU-VM host monitoring daemon and trace CLI
 Telemetry daemon (kernel/procfs, CPU PMU, per-chip TPU metrics),
 on-demand trace rendezvous for JAX and PyTorch processes, dyno CLI, and
 the Python client/fleet packages (dynolog_tpu for JAX, dynolog_tpu_torch
 for PyTorch; torch comes from the training environment).
EOF
cat > "$STAGE/$PKG/DEBIAN/conffiles" <<EOF
/etc/dynolog_tpu.flags
/etc/logrotate.d/dynolog-tpu
EOF
cat > "$STAGE/$PKG/DEBIAN/postinst" <<'EOF'
#!/bin/sh
set -e
# Don't fail in containers without systemd.
systemctl daemon-reload 2>/dev/null || true
echo "dynolog-tpu installed: 'systemctl enable --now dynolog-tpu' to start"
EOF
cat > "$STAGE/$PKG/DEBIAN/prerm" <<'EOF'
#!/bin/sh
set -e
# Stop before the binary disappears; tolerate systemd-less containers.
systemctl stop dynolog-tpu 2>/dev/null || true
EOF
cat > "$STAGE/$PKG/DEBIAN/postrm" <<'EOF'
#!/bin/sh
set -e
systemctl disable dynolog-tpu 2>/dev/null || true
systemctl daemon-reload 2>/dev/null || true
EOF
chmod 755 "$STAGE/$PKG/DEBIAN/postinst" "$STAGE/$PKG/DEBIAN/prerm" \
    "$STAGE/$PKG/DEBIAN/postrm"

mkdir -p "$OUT"
dpkg-deb --build --root-owner-group "$STAGE/$PKG" "$OUT/$PKG.deb" >/dev/null
echo "built $OUT/$PKG.deb"
