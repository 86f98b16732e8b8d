#!/usr/bin/env bash
# Builds an installable binary .rpm: daemon + dyno CLI + systemd unit +
# logrotate + flagfile + the Python client/fleet package — the rpm twin
# of scripts/make_deb.sh, same payload layout.
# (reference: scripts/rpm/{dynolog.spec,make_rpm.sh})
#
# Usage: scripts/make_rpm.sh [outdir]   (default: dist/)
set -euo pipefail
cd "$(dirname "$0")/.."

OUT=${1:-dist}
VERSION=$(sed -n 's/.*kVersion = "\(.*\)".*/\1/p' native/src/common/Version.h)

command -v rpmbuild >/dev/null 2>&1 || {
  echo "make_rpm.sh: rpmbuild not found (install rpm-build)" >&2
  exit 2
}

# Binaries must exist (CI builds first; local: scripts/build.sh).
test -x native/build/dynolog_tpu_daemon || ./scripts/build.sh

STAGE=$(mktemp -d)
trap 'rm -rf "$STAGE"' EXIT
ROOT=$STAGE/root

install -D -m755 native/build/dynolog_tpu_daemon \
    "$ROOT/usr/local/bin/dynolog_tpu_daemon"
install -D -m755 native/build/dyno "$ROOT/usr/local/bin/dyno"
install -D -m644 scripts/dynolog-tpu.service \
    "$ROOT/usr/lib/systemd/system/dynolog-tpu.service"
install -D -m644 scripts/dynolog-tpu.logrotate \
    "$ROOT/etc/logrotate.d/dynolog-tpu"

# Default flagfile — the single checked-in source shared with
# make_deb.sh; %config(noreplace) in the manifest preserves operator
# edits on upgrade (the conffile analog).
install -D -m644 scripts/dynolog_tpu.flags "$ROOT/etc/dynolog_tpu.flags"

# Python client + fleet packages (JAX and its PyTorch port). Fedora/RHEL put third-party packages in
# the interpreter's VERSIONED purelib (/usr/lib/python3.X/site-packages)
# — there is no unversioned path every interpreter searches, so a build
# host without python3 cannot produce an importable package: fail hard
# like the rpmbuild check above rather than ship a broken rpm.
PYDIR=$(python3 -c \
    'import sysconfig; print(sysconfig.get_paths()["purelib"])') || {
  echo "make_rpm.sh: python3 required to locate site-packages" >&2
  exit 2
}
for pkg in dynolog_tpu dynolog_tpu_torch; do
    mkdir -p "$ROOT$PYDIR/$pkg"
    cp -r "$pkg"/* "$ROOT$PYDIR/$pkg/"
done
find "$ROOT$PYDIR" -name __pycache__ -type d -exec rm -rf {} + \
    2>/dev/null || true

# %files manifest from the staged tree; /etc entries are config the
# operator may edit in place.
(cd "$ROOT" && find . -type f | sed 's|^\.||') | while read -r f; do
  case "$f" in
    /etc/*) echo "%config(noreplace) $f" ;;
    *) echo "$f" ;;
  esac
done > "$STAGE/files.list"

mkdir -p "$STAGE/topdir" "$OUT"
rpmbuild -bb scripts/dynolog-tpu.spec \
    --define "_topdir $STAGE/topdir" \
    --define "dtpu_version $VERSION" \
    --define "dtpu_stage $ROOT" \
    --define "dtpu_filelist $STAGE/files.list" \
    --buildroot "$STAGE/buildroot" >/dev/null
cp "$STAGE"/topdir/RPMS/*/*.rpm "$OUT/"
echo "built $(ls "$OUT"/dynolog-tpu-"$VERSION"*.rpm)"
