"""Per-file test-seconds of a pytest ``--junitxml`` report.

  python -m kfac_pytorch_tpu_torch.junit_seconds REPORT.xml [--top N]
  python -m kfac_pytorch_tpu_torch.junit_seconds OLD.xml NEW.xml

Sums each test file's case times and counts its cases. Under
``pytest-xdist --dist loadfile`` a file runs whole on one worker, and
files of few cases are scheduled last, so the report marks the files of
``TAIL_CASES`` cases or fewer: they make up the run's tail. With two
reports it prints both sums side by side, and their difference, for every
file in either.

Stdlib only; it reads nothing but the reports named.
"""

import argparse
import collections
import xml.etree.ElementTree as ET

#: files of at most this many cases run in the xdist tail
TAIL_CASES = 7


def file_of(classname):
    """``tests/test_x.py`` of a junit classname (``tests.test_x`` or
    ``tests.test_x.TestClass``)."""
    parts = classname.split('.')
    if parts and parts[0] == 'tests' and len(parts) > 1:
        return f'tests/{parts[1]}.py'
    return parts[0] + '.py'


def per_file(path):
    """``{file: (seconds, cases)}`` and the report's own wall time."""
    root = ET.parse(path).getroot()
    acc = collections.defaultdict(lambda: [0.0, 0])
    for tc in root.iter('testcase'):
        row = acc[file_of(tc.get('classname') or '?')]
        row[0] += float(tc.get('time') or 0.0)
        row[1] += 1
    wall = sum(float(s.get('time') or 0.0) for s in root.iter('testsuite'))
    return {f: (t, n) for f, (t, n) in acc.items()}, wall


def report(path, top=None):
    files, wall = per_file(path)
    total = sum(t for t, _ in files.values())
    print(f'{path}: {len(files)} files, {sum(n for _, n in files.values())}'
          f' cases, {total:.1f} test-seconds, wall {wall:.1f} s')
    tail = sum(t for t, n in files.values() if n <= TAIL_CASES)
    print(f'  files of <= {TAIL_CASES} cases (the tail): {tail:.1f} '
          'test-seconds')
    rows = sorted(files.items(), key=lambda kv: -kv[1][0])
    for f, (t, n) in rows[:top]:
        mark = ' tail' if n <= TAIL_CASES else ''
        print(f'  {t:8.1f} s {n:5d} cases  {f}{mark}')


def compare(old, new):
    a, wa = per_file(old)
    b, wb = per_file(new)
    print(f'wall {wa:.1f} -> {wb:.1f} s; test-seconds '
          f'{sum(t for t, _ in a.values()):.1f} -> '
          f'{sum(t for t, _ in b.values()):.1f}')
    rows = sorted(set(a) | set(b),
                  key=lambda f: -max(a.get(f, (0, 0))[0],
                                     b.get(f, (0, 0))[0]))
    for f in rows:
        ta, na = a.get(f, (0.0, 0))
        tb, nb = b.get(f, (0.0, 0))
        print(f'  {ta:8.1f} ({na:4d}) -> {tb:8.1f} ({nb:4d})  '
              f'{tb - ta:+8.1f}  {f}')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('reports', nargs='+', help='one report, or OLD NEW')
    p.add_argument('--top', type=int, default=None,
                   help='list only the N slowest files')
    args = p.parse_args(argv)
    if len(args.reports) == 2:
        compare(*args.reports)
    else:
        for path in args.reports:
            report(path, args.top)


if __name__ == '__main__':
    main()
