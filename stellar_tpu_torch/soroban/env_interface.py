"""The soroban env interface registry: module chars, function order,
and the derived single-char export names real SDK-compiled contracts
import (reference boundary: the ``soroban-env-host`` crates linked at
``src/rust/src/lib.rs:61-83`` — their interface definition file is not
vendored in the reference snapshot, so this table reconstructs the
published interface).

Export-name scheme (verified against the reference's own compiled
fixtures, see ``legacy_abi.py``): every host module exports under a
single-character module name, and each function's export name is its
index within the module encoded over the alphabet
``_ 0-9 a-z A-Z`` — index 0 is ``"_"``, index 1 is ``"0"``, index 11
is ``"a"``, and so on.

Evidence tiers for the orderings below:

- **fixture-verified**: ``("l","_")`` = ``put_contract_data`` and
  ``("l","2")`` = ``del_contract_data`` are imported by
  the reference's ``src/testdata/example_contract_data.wasm`` with the
  CRUD arity, pinning the ledger module's first four entries.
- **derived**: the remaining orderings follow the published
  soroban-env interface (module groupings and declaration order as of
  protocol 20-22). They live in this one table precisely so a
  mis-derived index is a one-line fix.

``make_imports`` (env.py) registers every handler under BOTH its
``(module_char, export_char)`` name — what real contracts import —
and ``(module_char, long_name)`` for the readable dialect this repo's
own ``wasm_builder`` contracts use.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["EXPORT_CHARS", "MODULES", "export_name", "short_to_long",
           "long_to_short", "evidence_tier", "describe_binding",
           "FIXTURE_VERIFIED", "MIN_PROTOCOL", "SOROBAN_LAUNCH_PROTOCOL"]

# Minimum ledger protocol at which each host function exists, mirroring
# the reference's one-host-crate-per-protocol-era scheme
# (src/rust/Cargo.toml:51-80: p21/p22 hosts are pinned so historical
# replay is bit-exact). Functions absent here exist from the soroban
# launch protocol (20). CAP-51 (secp256r1) shipped in protocol 21;
# CAP-59 (BLS12-381 family) in protocol 22.
SOROBAN_LAUNCH_PROTOCOL = 20


def _current_protocol() -> int:
    from stellar_tpu_torch.protocol import CURRENT_LEDGER_PROTOCOL_VERSION
    return CURRENT_LEDGER_PROTOCOL_VERSION


MIN_PROTOCOL: Dict[str, int] = {
    # the reference's vnext-gated test hook: enabled only at the
    # current protocol (tracks the version constant, not an era)
    "protocol_gated_dummy": _current_protocol(),
    "verify_sig_ecdsa_secp256r1": 21,
    "bls12_381_check_g1_is_in_subgroup": 22,
    "bls12_381_g1_add": 22,
    "bls12_381_g1_mul": 22,
    "bls12_381_g1_msm": 22,
    "bls12_381_map_fp_to_g1": 22,
    "bls12_381_hash_to_g1": 22,
    "bls12_381_check_g2_is_in_subgroup": 22,
    "bls12_381_g2_add": 22,
    "bls12_381_g2_mul": 22,
    "bls12_381_g2_msm": 22,
    "bls12_381_map_fp2_to_g2": 22,
    "bls12_381_hash_to_g2": 22,
    "bls12_381_multi_pairing_check": 22,
    "bls12_381_fr_add": 22,
    "bls12_381_fr_sub": 22,
    "bls12_381_fr_mul": 22,
    "bls12_381_fr_pow": 22,
    "bls12_381_fr_inv": 22,
}

# (module char, long name) orderings pinned by offline artifacts — the
# reference's own SDK-compiled fixtures import these with known
# semantics (see legacy_abi.py and tests/test_reference_fixtures.py).
# Everything else in MODULES is tier "derived".
FIXTURE_VERIFIED = frozenset([
    ("l", "put_contract_data"),
    ("l", "has_contract_data"),
    ("l", "get_contract_data"),
    ("l", "del_contract_data"),
])

EXPORT_CHARS = ("_0123456789abcdefghijklmnopqrstuvwxyz"
                "ABCDEFGHIJKLMNOPQRSTUVWXYZ")

# module char -> (module name, [function long names in export order])
MODULES: Dict[str, Tuple[str, List[str]]] = {
    "x": ("context", [
        "log_from_linear_memory",
        "obj_cmp",
        "contract_event",
        "get_ledger_version",
        "get_ledger_sequence",
        "get_ledger_timestamp",
        "fail_with_error",
        "get_ledger_network_id",
        "get_current_contract_address",
        "get_max_live_until_ledger",
    ]),
    "i": ("int", [
        "obj_from_u64",
        "obj_to_u64",
        "obj_from_i64",
        "obj_to_i64",
        "obj_from_u128_pieces",
        "obj_to_u128_lo64",
        "obj_to_u128_hi64",
        "obj_from_i128_pieces",
        "obj_to_i128_lo64",
        "obj_to_i128_hi64",
        "obj_from_u256_pieces",
        "u256_val_from_be_bytes",
        "u256_val_to_be_bytes",
        "obj_to_u256_hi_hi",
        "obj_to_u256_hi_lo",
        "obj_to_u256_lo_hi",
        "obj_to_u256_lo_lo",
        "obj_from_i256_pieces",
        "i256_val_from_be_bytes",
        "i256_val_to_be_bytes",
        "obj_to_i256_hi_hi",
        "obj_to_i256_hi_lo",
        "obj_to_i256_lo_hi",
        "obj_to_i256_lo_lo",
        "u256_add",
        "u256_sub",
        "u256_mul",
        "u256_div",
        "u256_rem_euclid",
        "u256_pow",
        "u256_shl",
        "u256_shr",
        "i256_add",
        "i256_sub",
        "i256_mul",
        "i256_div",
        "i256_rem_euclid",
        "i256_pow",
        "i256_shl",
        "i256_shr",
        "timepoint_obj_from_u64",
        "timepoint_obj_to_u64",
        "duration_obj_from_u64",
        "duration_obj_to_u64",
    ]),
    "m": ("map", [
        "map_new",
        "map_put",
        "map_get",
        "map_del",
        "map_len",
        "map_has",
        "map_key_by_pos",
        "map_val_by_pos",
        "map_keys",
        "map_values",
        "map_new_from_linear_memory",
        "map_unpack_to_linear_memory",
    ]),
    "v": ("vec", [
        "vec_new",
        "vec_put",
        "vec_get",
        "vec_del",
        "vec_len",
        "vec_push_front",
        "vec_pop_front",
        "vec_push_back",
        "vec_pop_back",
        "vec_front",
        "vec_back",
        "vec_insert",
        "vec_append",
        "vec_slice",
        "vec_first_index_of",
        "vec_last_index_of",
        "vec_binary_search",
        "vec_new_from_linear_memory",
        "vec_unpack_to_linear_memory",
    ]),
    "l": ("ledger", [
        # first four fixture-verified (see module docstring)
        "put_contract_data",
        "has_contract_data",
        "get_contract_data",
        "del_contract_data",
        "extend_contract_data_ttl",
        "extend_current_contract_instance_and_code_ttl",
        "extend_contract_instance_and_code_ttl",
        "create_contract",
        "create_asset_contract",
        "get_asset_contract_id",
        "upload_wasm",
        "update_current_contract_wasm",
        "get_contract_id",
    ]),
    "d": ("call", [
        "call",
        "try_call",
    ]),
    "b": ("buf", [
        "serialize_to_bytes",
        "deserialize_from_bytes",
        "string_copy_to_linear_memory",
        "symbol_copy_to_linear_memory",
        "string_new_from_linear_memory",
        "symbol_new_from_linear_memory",
        "string_len",
        "symbol_len",
        "bytes_copy_to_linear_memory",
        "bytes_copy_from_linear_memory",
        "bytes_new_from_linear_memory",
        "bytes_new",
        "bytes_put",
        "bytes_get",
        "bytes_del",
        "bytes_len",
        "bytes_push",
        "bytes_pop",
        "bytes_front",
        "bytes_back",
        "bytes_insert",
        "bytes_append",
        "bytes_slice",
        "symbol_index_in_linear_memory",
    ]),
    "c": ("crypto", [
        "compute_hash_sha256",
        "verify_sig_ed25519",
        "compute_hash_keccak256",
        "recover_key_ecdsa_secp256k1",
        "verify_sig_ecdsa_secp256r1",
        # protocol 22 (CAP-59) BLS12-381 family
        "bls12_381_check_g1_is_in_subgroup",
        "bls12_381_g1_add",
        "bls12_381_g1_mul",
        "bls12_381_g1_msm",
        "bls12_381_map_fp_to_g1",
        "bls12_381_hash_to_g1",
        "bls12_381_check_g2_is_in_subgroup",
        "bls12_381_g2_add",
        "bls12_381_g2_mul",
        "bls12_381_g2_msm",
        "bls12_381_map_fp2_to_g2",
        "bls12_381_hash_to_g2",
        "bls12_381_multi_pairing_check",
        "bls12_381_fr_add",
        "bls12_381_fr_sub",
        "bls12_381_fr_mul",
        "bls12_381_fr_pow",
        "bls12_381_fr_inv",
    ]),
    "a": ("address", [
        "require_auth_for_args",
        "require_auth",
        "strkey_to_address",
        "address_to_strkey",
        "authorize_as_curr_contract",
    ]),
    "t": ("test", [
        "dummy0",
        "protocol_gated_dummy",
    ]),
    "p": ("prng", [
        "prng_reseed",
        "prng_bytes_new",
        "prng_u64_in_inclusive_range",
        "prng_vec_shuffle",
    ]),
}


def export_name(index: int) -> str:
    """Index -> export name: single char for 0..62, then two chars."""
    n = len(EXPORT_CHARS)
    if index < n:
        return EXPORT_CHARS[index]
    return EXPORT_CHARS[index // n - 1] + EXPORT_CHARS[index % n]


def short_to_long() -> Dict[Tuple[str, str], str]:
    """{(module_char, export_char): long function name}."""
    out = {}
    for mod_char, (_mod_name, fns) in MODULES.items():
        for i, fn in enumerate(fns):
            out[(mod_char, export_name(i))] = fn
    return out


def long_to_short() -> Dict[str, Tuple[str, str]]:
    """{long function name: (module_char, export_char)} — long names
    are unique across modules in the soroban interface."""
    out = {}
    for mod_char, (_mod_name, fns) in MODULES.items():
        for i, fn in enumerate(fns):
            out[fn] = (mod_char, export_name(i))
    return out


def evidence_tier(mod_char: str, long_name: str) -> str:
    """'fixture-verified' when an offline artifact pins this ordering,
    else 'derived' (see module docstring for what each tier means)."""
    return "fixture-verified" \
        if (mod_char, long_name) in FIXTURE_VERIFIED else "derived"


def describe_binding(mod_char: str, export_char: str) -> str:
    """Human context for a link error on (module char, export name):
    which long name the registry derivation chose, at which index, and
    under which evidence tier — so a mis-derived ordering reads as
    exactly that, not as a mystery arity bug."""
    entry = MODULES.get(mod_char)
    if entry is None:
        return ""
    mod_name, fns = entry
    long = short_to_long().get((mod_char, export_char))
    if long is None:
        if len(export_char) > 2 or export_char in fns:
            # the readable long-name dialect (wasm_builder contracts /
            # historical aliases) — not a registry-derived binding
            return f" (module {mod_name!r}: long-name alias import, " \
                   f"not registry-derived)"
        return f" (module {mod_name!r}: no registry entry for export " \
               f"{export_char!r})"
    idx = fns.index(long)
    return (f" (registry: module {mod_name!r} index {idx} -> "
            f"{long!r}, evidence tier: "
            f"{evidence_tier(mod_char, long)} — if the tier is "
            f"'derived', suspect the ordering in env_interface.MODULES)")
