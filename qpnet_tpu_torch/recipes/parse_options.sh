# Kaldi-style --name value option parser for recipe scripts.
# Sets shell variable $name to value for every --name value pair; the
# variable must already exist (declared with a default at the top of the
# calling script).  Same contract as the reference's src/parse_options.sh.

while true; do
  [ -z "${1:-}" ] && break
  case "$1" in
    --*)
      name=$(echo "$1" | sed s/^--// | sed s/-/_/g)
      eval '[ -z "${'"$name"'+xxx}" ]' && \
        { echo "$0: invalid option $1" >&2; exit 1; }
      eval "$name=\"$2\""
      shift 2
      ;;
    *) break ;;
  esac
done
true
