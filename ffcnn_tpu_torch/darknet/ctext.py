"""C-standard-library-compatible text helpers, the port's copy of
``ffcnn_tpu/darknet/ctext.py``.

The reference parser (``ffcnn.c:64-84``) reads Darknet ``.cfg`` files with
``strstr``/``atoi``/``atof`` and a handful of quirky conventions
(substring key lookup anywhere in a section, leading-garbage-tolerant number
parsing).  Darknet cfgs in the wild rely on that tolerance, so the
*observable* parsing behavior is reproduced here with small pure-Python
equivalents rather than stricter parsing that would reject working models.
"""

from __future__ import annotations


def atoi(s: str) -> int:
    """C ``atoi``: skip leading whitespace, optional sign, digits; 0 on garbage."""
    i, n = 0, len(s)
    while i < n and s[i] in " \t\r\n\v\f":
        i += 1
    j = i
    if j < n and s[j] in "+-":
        j += 1
    k = j
    while k < n and s[k].isdigit():
        k += 1
    if k == j:
        return 0
    return int(s[i:k])


def atof(s: str) -> float:
    """C ``atof``: parse a leading floating-point literal; 0.0 on garbage."""
    i, n = 0, len(s)
    while i < n and s[i] in " \t\r\n\v\f":
        i += 1
    j = i
    if j < n and s[j] in "+-":
        j += 1
    intpart = j
    while j < n and s[j].isdigit():
        j += 1
    if j < n and s[j] == ".":
        j += 1
        while j < n and s[j].isdigit():
            j += 1
    # exponent
    if j > intpart and j < n and s[j] in "eE":
        k = j + 1
        if k < n and s[k] in "+-":
            k += 1
        if k < n and s[k].isdigit():
            while k < n and s[k].isdigit():
                k += 1
            j = k
    try:
        return float(s[i:j])
    except ValueError:
        return 0.0


def parse_param(section: str, key: str) -> str:
    """Reference ``parse_params`` (``ffcnn.c:64-84``): find the first occurrence
    of *key* anywhere in the section text (substring match — deliberately
    tolerant), skip any run of ``=``/space, and return chars up to newline.
    Returns '' when the key is absent (callers then apply their default)."""
    p = section.find(key)
    if p < 0:
        return ""
    p += len(key)
    while p < len(section) and section[p] in "= ":
        p += 1
    end = p
    while end < len(section) and section[end] != "\n":
        end += 1
    return section[p:end]


def align(x: int, n: int) -> int:
    """Reference ``ALIGN`` macro (``utils.h:6``): round up to a power-of-two multiple."""
    return (x + n - 1) & ~(n - 1)
