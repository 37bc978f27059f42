"""Puts the benchmark's folder on the path and registers the ``ti2v`` job
kind's faults (``faults_ti2v.py``) before the tests' modules read
``faults.FAULTS`` while they are collected."""

import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent)]

import faults_ti2v  # noqa: E402,F401
