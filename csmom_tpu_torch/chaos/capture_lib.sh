# Artifact-landing rules of the port's captures (sourced, no side
# effects); `python -m csmom_tpu_torch.cli rehearse` lands its mini and
# shell scenarios through them, and tests/test_torch_capture_lib.py pins
# them.
#
# Contract:
#  - land_artifact RAW ART: extract RAW's last JSON line into ART.
#    Refuses to overwrite an existing ART — unless ART is a PARTIAL
#    (deadline-hit dump) and the new line is FULL, or both are partials
#    and the new one measured STRICTLY more rows/phases: a partial is
#    provisional evidence, never a blocker for its own upgrade, and a
#    richer deadline-hit capture upgrades a thinner one.
#  - promote_capture NAME RAW ART: a finished RAW.tmp with a FULL
#    summary claims RAW (the done-marker a capture loop checks); a
#    PARTIAL one is kept aside as RAW.partial and landed provisionally,
#    so the loop retries that capture.
#  - A landed artifact is re-validated as parseable JSON after the write
#    and before the rename: a short write (ENOSPC, dying disk) between
#    the formatter and the mv must never replace a good artifact with a
#    truncated one.  The rehearsal pins this via
#    CSMOM_FAULT_LAND_TRUNCATE_BYTES, which simulates exactly that short
#    write; the CSMOM_FAULT_* env names are the shell side of the
#    csmom_tpu_torch.chaos fault-plan contract.
#
# Callers define log() (the rehearsal logs to stderr; tests stub it).

_measured_rows() {  # stdin: one JSON record -> its measured-row count
  # a capture's substance is its measurement list ("rows" or "phases",
  # top-level or nested under "extra", where bench-child and minibench
  # partials carry theirs); unparseable or listless -> 0.  Mirror of
  # csmom_tpu_torch.chaos.invariants.measured_rows: the two sides of the
  # landing contract must size a partial identically or a
  # strictly-richer partial could be refused its upgrade.
  python -c '
import json, sys
try:
    d = json.load(sys.stdin)
except Exception:
    print(0); raise SystemExit
extra = d.get("extra") if isinstance(d.get("extra"), dict) else {}
for k in ("rows", "phases"):
    for holder in (d, extra):
        if isinstance(holder.get(k), list):
            print(len(holder[k])); raise SystemExit
print(0)' 2>/dev/null || echo 0
}

land_artifact() {  # $1 raw log, $2 artifact path
  new_line=$(grep '^{' "$1" | tail -1)
  if [ -s "$2" ]; then
    if grep -q '"partial":' "$2"; then
      if ! printf '%s' "$new_line" | grep -q '"partial":'; then
        log "artifact $2 is a partial — upgrading with full capture"
      else
        old_rows=$(_measured_rows < "$2")
        new_rows=$(printf '%s' "$new_line" | _measured_rows)
        if [ "$new_rows" -gt "$old_rows" ] 2>/dev/null; then
          log "artifact $2 is a partial ($old_rows rows) — upgrading with richer partial ($new_rows rows)"
        else
          log "artifact $2 already exists — refusing to overwrite"
          return 0
        fi
      fi
    else
      log "artifact $2 already exists — refusing to overwrite"
      return 0
    fi
  fi
  if printf '%s\n' "$new_line" | python -m json.tool > "$2".tmp 2>/dev/null \
      && [ -s "$2".tmp ]; then
    if [ -n "${CSMOM_FAULT_LAND_TRUNCATE_BYTES:-}" ]; then
      # chaos fault: an ENOSPC/short write hitting between the formatter
      # and the rename (rehearse's land-short-write scenario)
      head -c "$CSMOM_FAULT_LAND_TRUNCATE_BYTES" "$2".tmp > "$2".tmp.chaos \
        && mv "$2".tmp.chaos "$2".tmp
      log "chaos: truncated $2.tmp to ${CSMOM_FAULT_LAND_TRUNCATE_BYTES} bytes"
    fi
    if python -c 'import json,sys; json.load(open(sys.argv[1]))' "$2".tmp \
        2>/dev/null; then
      mv "$2".tmp "$2"
    else
      rm -f "$2".tmp
      log "artifact $2 failed post-write JSON validation (short write/ENOSPC?) — not landed, existing artifact untouched"
    fi
  else
    rm -f "$2".tmp
    log "summary extraction FAILED for $2 (artifact not written)"
  fi
}

promote_capture() {  # $1 name for logs, $2 raw out path, $3 artifact path
  if grep '^{' "$2".tmp | tail -1 | grep -q '"partial":'; then
    mv "$2".tmp "$2".partial
    land_artifact "$2".partial "$3"
    log "$1 partial capture kept as .partial — will retry for a full one"
  else
    mv "$2".tmp "$2"
    land_artifact "$2" "$3"
  fi
}
