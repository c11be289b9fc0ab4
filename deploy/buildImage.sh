#!/bin/sh
# Build the service image (reference: buildImage.sh builds + retags the
# multi-stage C++ image; one stage suffices here).
set -e
cd "$(dirname "$0")/.."
docker build -t opendlv-perception-vision-orbslam2-jax:latest -f deploy/Dockerfile .
