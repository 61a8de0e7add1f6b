"""Registration-based typed config files and CLI flags
(ref go/config/config.go).

Config files have a ``[title]`` line and ``Name = Value`` pairs with
``#`` comments; names are case-insensitive; unknown names, duplicates and
conversion failures produce line-numbered diagnostics.  The same
converters parse ``--flag value...`` command lines
(ref go/config/config.go:284-456).

The port's own copy of ``minnow_tpu/utils/config.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

__all__ = ["ConfigVars", "ConfigError", "read_config", "read_flags"]


class ConfigError(Exception):
    pass


_TYPE_NAMES = {
    "int": "int", "ints": "int list",
    "float": "float", "floats": "float list",
    "string": "string", "strings": "string list",
    "bool": "bool", "bools": "bool list",
}


def _conv_int(s: str):
    return int(s.strip())


def _conv_float(s: str):
    return float(s.strip())


def _conv_string(s: str):
    return s.strip(" ")


def _conv_bool(s: str):
    t = s.strip().lower()
    # strconv.ParseBool accepts 1/t/true/0/f/false (case-insensitive)
    if t in ("1", "t", "true"):
        return True
    if t in ("0", "f", "false"):
        return False
    raise ValueError(s)


def _list_conv(conv):
    def f(s: str):
        return [conv(tok) for tok in s.split(",")]

    return f


_CONVERTERS = {
    "int": _conv_int, "float": _conv_float, "string": _conv_string,
    "bool": _conv_bool,
    "ints": _list_conv(_conv_int), "floats": _list_conv(_conv_float),
    "strings": _list_conv(_conv_string), "bools": _list_conv(_conv_bool),
}


class ConfigVars:
    """Typed variable registry (ref go/config/config.go:106-275).
    Values are held in ``.values`` (name -> value); registration sets the
    default."""

    def __init__(self, name: str):
        self.name = name
        self.var_names: list[str] = []
        self.var_types: list[str] = []
        self.values: dict[str, object] = {}

    def _register(self, vtype, name, default):
        self.var_names.append(name)
        self.var_types.append(vtype)
        self.values[name] = default

    def int(self, name, default=0):
        self._register("int", name, int(default))

    def float(self, name, default=0.0):
        self._register("float", name, float(default))

    def string(self, name, default=""):
        self._register("string", name, str(default))

    def bool(self, name, default=False):
        self._register("bool", name, bool(default))

    def ints(self, name, default=()):
        self._register("ints", name, list(default))

    def floats(self, name, default=()):
        self._register("floats", name, list(default))

    def strings(self, name, default=()):
        self._register("strings", name, list(default))

    def bools(self, name, default=()):
        self._register("bools", name, list(default))

    def __getitem__(self, name):
        return self.values[name]

    def _lookup(self, name: str):
        low = name.lower()
        for i, vn in enumerate(self.var_names):
            if vn.lower() == low:
                return i
        return -1

    def _convert(self, name: str, value: str) -> bool:
        i = self._lookup(name)
        try:
            self.values[self.var_names[i]] = _CONVERTERS[
                self.var_types[i]](value)
            return True
        except (ValueError, TypeError):
            return False


def _remove_comments(lines):
    """(ref go/config/config.go:464-488) -> (lines, 1-based line nums)"""
    out, nums = [], []
    for i, line in enumerate(lines):
        comment = line.find("#")
        if comment != -1:
            line = line[:comment]
        line = line.strip(" ")
        if line:
            out.append(line)
            nums.append(i + 1)
    return out, nums


def _association_list(lines):
    """(ref go/config/config.go:490-509) -> (names, vals, err_line_idx)"""
    names, vals = [], []
    for i, line in enumerate(lines):
        eq = line.find("=")
        if eq == -1:
            return None, None, i
        name = line[:eq].strip(" ")
        val = line[eq + 1:].strip(" ") if len(line) - 1 > eq else ""
        if not name:
            return None, None, i
        names.append(name)
        vals.append(val)
    return names, vals, -1


def _apply(names, vals, nums_or_none, vars_, fname_or_flag):
    """Shared validation + conversion (ref config.go:319-356,422-453)."""
    flags = nums_or_none is None

    for i, name in enumerate(names):
        if vars_._lookup(name) == -1:
            if flags:
                raise ConfigError(
                    "The flag '%s' cannot be set for this program." % name)
            raise ConfigError(
                "Line %d of the config file %s assigns a value to the "
                "variable '%s', but config files of type %s don't have "
                "that variable." % (nums_or_none[i + 1], fname_or_flag,
                                    name, vars_.name))

    seen = {}
    for i, name in enumerate(names):
        low = name.lower()
        if low in seen:
            if flags:
                raise ConfigError(
                    "The flag '%s' was assigned twice." % names[seen[low]])
            raise ConfigError(
                "Lines %d and %d of the config file %s both assign a value "
                "to the variable '%s'." % (nums_or_none[seen[low] + 1],
                                           nums_or_none[i + 1],
                                           fname_or_flag, names[seen[low]]))
        seen[low] = i

    for i, (name, val) in enumerate(zip(names, vals)):
        if not vars_._convert(name, val):
            j = vars_._lookup(name)
            type_name = _TYPE_NAMES[vars_.var_types[j]]
            a = "an" if type_name[0] == "i" else "a"
            if flags:
                raise ConfigError(
                    "I could not parse the flag '%s', because it expects "
                    "values of type %s and '%s' cannot be converted to %s "
                    "%s." % (vars_.var_names[j], type_name, val, a,
                             type_name))
            raise ConfigError(
                "I could not parse line %d of the config file %s because "
                "'%s' expects values of type %s and '%s' cannot be "
                "converted to %s %s." % (nums_or_none[i + 1],
                                         fname_or_flag,
                                         vars_.var_names[j], type_name,
                                         val, a, type_name))


def read_config(fname: str, vars_: ConfigVars) -> None:
    """Parse a ``[title]`` config file into registered variables
    (ref go/config/config.go:284-359).  Raises ConfigError with
    line-numbered diagnostics."""
    with open(fname) as f:
        raw = f.read()

    lines, nums = _remove_comments(raw.split("\n"))
    if not lines or lines[0] != "[%s]" % vars_.name:
        raise ConfigError(
            "I expected the config file %s to have the header [%s] at the "
            "top, but didn't find it." % (fname, vars_.name))

    names, vals, err = _association_list(lines[1:])
    if err != -1:
        raise ConfigError(
            "I could not parse line %d of the config file %s because it "
            "did not take the form of a variable assignment."
            % (nums[err + 1], fname))
    _apply(names, vals, nums, vars_, fname)


def read_flags(args, vars_: ConfigVars) -> None:
    """Parse ``--flag value...`` argument lists with the same converters
    (ref go/config/config.go:361-456)."""
    if not args:
        return
    for arg in args:
        if "=" in arg:
            raise ConfigError(
                "The argument '%s' contains an equals sign." % arg)

    is_flag = [len(a) > 1 and a[:2] == "--" for a in args]
    if not is_flag[0]:
        raise ConfigError(
            "The argument '%s' does not have a flag." % args[0])

    var_names, values = [], []
    curr: list[str] = []
    var_names.append(args[0].lstrip("-"))
    for i in range(1, len(args)):
        if not is_flag[i]:
            curr.append(args[i])
        else:
            values.append(",".join(curr))
            curr = []
            var_names.append(args[i].lstrip("-"))
    values.append(",".join(curr))

    for name, value in zip(var_names, values):
        if value == "":
            raise ConfigError(
                "The flag '%s' was supplied, but wasn't set to a value."
                % name)

    _apply(var_names, values, None, vars_, "<flags>")
