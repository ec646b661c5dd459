"""Verify the introsort replica matches g++ std::sort exactly (incl. ties)."""

import random
import subprocess
import tempfile

import pytest

from sequence_alignment_tools.utils.introsort import introsort

CXX_SRC = r"""
#include <algorithm>
#include <cstdio>
#include <vector>
int main() {
  int n; if (scanf("%d", &n) != 1) return 1;
  std::vector<std::pair<long,long>> v(n);
  for (int i = 0; i < n; i++) scanf("%ld %ld", &v[i].first, &v[i].second);
  std::sort(v.begin(), v.end(),
            [](const std::pair<long,long>&a, const std::pair<long,long>&b){
              return a.first < b.first; });
  for (int i = 0; i < n; i++) printf("%ld %ld\n", v[i].first, v[i].second);
  return 0;
}
"""


@pytest.fixture(scope="module")
def cxx_sort(tmp_path_factory):
    d = tmp_path_factory.mktemp("cxxsort")
    src = d / "s.cpp"
    src.write_text(CXX_SRC)
    exe = d / "s"
    try:
        subprocess.run(["g++", "-O2", "-o", str(exe), str(src)], check=True)
    except Exception:
        pytest.skip("g++ unavailable")
    return str(exe)


@pytest.mark.parametrize("n,keyrange,seed", [
    (5, 3, 0), (16, 4, 1), (17, 4, 2), (50, 5, 3), (300, 20, 4),
    (1000, 30, 5), (1000, 2, 6), (5000, 100, 7), (257, 1, 8), (64, 64, 9),
])
def test_matches_gcc(cxx_sort, n, keyrange, seed):
    rng = random.Random(seed)
    data = [(rng.randrange(keyrange), i) for i in range(n)]
    inp = f"{n}\n" + "\n".join(f"{k} {v}" for k, v in data) + "\n"
    out = subprocess.run([cxx_sort], input=inp, capture_output=True,
                         text=True, check=True).stdout
    expect = [tuple(map(int, l.split())) for l in out.splitlines()]
    mine = list(data)
    introsort(mine, lambda a, b: a[0] < b[0])
    assert mine == expect
