"""Production Xet content-addressing constants (interop-critical).

The port's own copy of ``zest_tpu/cas/xet_constants.py``, bit for bit:
the gearhash ``GEAR_TABLE`` of the content-defined chunker, the BLAKE3
keyed-mode domain keys for chunk hashes (``CHUNK_KEY``) and merkle
interior nodes (``NODE_KEY``), the all-zero ``FILE_SALT`` of file
hashes, and the chunk-size limits. A single wrong bit changes every
content address downstream; tests/test_torch_cas.py holds the port's
cut points and hashes equal to the JAX package's.

Merkle aggregation (hashing.merkle_root): children group left-to-right;
a group closes at its k-th child (k >= 3) when the child hash's last u64
(little-endian) is divisible by 4, or unconditionally at k == 9; the parent
hashes the text ``"{hash_hex} : {size}\n"`` per child under NODE_KEY.
A single leaf is its own root.
"""

from __future__ import annotations

import base64
import struct

CHUNK_KEY = bytes.fromhex(
    "6697f5775b9550de3135cbaca597181c9de421109beb2b58b4d0b04b93adf229"
)
NODE_KEY = bytes.fromhex(
    "017ec5c7a5472996fd946666b48a02e65ddd536f37c76dd2f86352e64a53713f"
)
FILE_SALT = bytes(32)

MASK = 0xFFFF_0000_0000_0000
MIN_CHUNK = 8 * 1024
TARGET_CHUNK = 64 * 1024
MAX_CHUNK = 128 * 1024

# Merkle grouping parameters (see module docstring).
GROUP_MIN = 3
GROUP_MAX = 9
GROUP_MOD = 4

_GEAR_B85 = (
    "S@l5ZsndwC)*$UU_s3FJt8$5nX^FB$cgK#l)rksgw=sH)K39)6OW8K*+&0D?w$)TsPE2|r%bFu7M"
    "zeIJ61k%sKBxve_qqZvY>nrTikb}-_btict<#1OIt7)EA_qFS@$@cQu77}^l&lY>f!5f7>jQHR53"
    "O(&+<vf`b};=_wJ)7$Xr!JIf=~beD9n$j27|D~{Yp3Xif6DsHgv6qtB0TQHpgqezn>EF?WCAoS4j"
    "~_#d}AU1_1y7%<7yPfH%4yZJVTH)^G4TONZlvmwsrO<JeHDa|WS#AoLMpp3ki0agbMsALk$?n~EB"
    "E{nOPebI1|h%}w3_FFA)=95Jct|3JJKwvKe$Z@(b+jha`lvBC)(+U2H(E}<gB3d1kVXF~VE{wiKI"
    "d!!-2^vIbl!_NeiN=x3lX?<`Vau~JuAT0BHShj{T3@5LKh_(O#d60_R<kl6Tnc=dRoPJM80pk-_w"
    "|mOWVDYdkri3NG$h=)*6X@ryT9t<llyCq5Z(^Pk2$ANBqB!0!*J^jY&%pe`9{_9nC&YW^xOAk)SY"
    "7K77V-AF(QxN&TOZ2_M@)T}<{7fEO0B1EIK0dN0Y8`D3Y~<^aQA8feea`l{=L11)6xgXFc*1jmdP"
    "rA+62YMYp6HSonWdSW_<DUhvuqHuqLLg2U|){H<?;>-mWZL=6-{ag$Gvsldb4(*zHpg;n@HH*V`P"
    "@vO5NzveE%6@pr2SL>px0RRUG)#uS`HsFeG7_4UBU8xB#&<I3bV3o-xzEgFj~CNq43L_z9E3twjx"
    ">+Fq5rqg>SUIX=l`EQZ&i2F43e;Xo(*hz0V=gz*JN{<i7%J^97*kt^Yh8c|jHk!Y>PjEPGOupyQ2"
    "g@?xkO)Ps_92ZTrHLiLzp-3nan7QgbD<zcSo`Iw<KO3}>kT|Blgbbbd+o1;=>8`sAFJZ|Z5-dCBl"
    "UC#tkKO)PU17I|8M{R7I>G%d+4m9Nnj|nS|^g2S&8x8ff0tn89qotpmLeJcra0BH_dSGWSIP`69o"
    "VOgFwkx7`9lz-ryydg;3}Tlzl$<JNuWB&P%ouZDJmN(N}waP*e<379`?yae3jshgIn!GOXEeKEL0"
    "Ze3c^r6~0R&etjIEyNsi_SjVEPFe^Un&Y&L+k-1=gi>0;;HD;opTir85qrm|{eLMZaClPa0B!EHt"
    "%NPx%g<+*-Pql=Hy#jjnV^HR2-4SnTs}!jGA|L<&QrNjIk-pZ9SBkFbwuw<`C=A*PwNsStUW9lWs"
    "b2ipXQxUU8NY_B<rQSewZ;GdE}{sI7Z7tMCCZBj8xSq+`=}<egzZ5)2HYqQ5+ddkCT(#0>-80*&b"
    "k3JPQw<6uKjVloLf2RNEUJ~An7as9LcjQ9ovIKrKYjc8b*EBYliD?<QMGXe8l@XK)&F(1f40>#9*"
    "P`G&YRV$cF5GnWLDW60I2_?}MUYYxK;f7sgoj-p*1igWarY5r?!b>C2w;*6;uTiIgvm$=KCBg!KU"
    "{qH-9D@;rME#H51qmZ2NVEbJhF6XRK);I@-y>w|pE8O{IzJDf-MHCM|ZTUysyH@_}+bvbE0g8q9T"
    ")!Cdg62X1f1AStILW8H9=}}+l6UBWY7I<F#DH?mSEoQqhn9bDyOmlT@fScoSBO3b#@G4h+g&*l^F"
    "Hdu#^4%-~wZ?+K-k@Oz#_Bs<m}x;ryOYSx0e%=<VTBNFU3@33Fs}G_kt`|_fopt`XKB%`nYMLXn+"
    "BTaYR>=w1QFg~`U=GJ!)KADdJ<zGO^MNIBIX@pCPypg9ju7aJZDQ4;x=#)9XeGgU$_7OJ#QlzOiu"
    "6e0`|EPX5QA>9Fa%+ReAiOy^Sd^1O0{T;rhO_FHk4G9%jwNQ9=XbHW&v~(_|AwKA7@#Y_oy@@Mii"
    "J1Cd3s_sU0@oCX{MAyP|P$KMbswWwDdJ~dl&Y}t<KEHOmRW%|7aMJ|-Q8<bZPr-o4Qt<F)?6|%$r"
    "0zwqvRS>QKROCW$gg{I6$h^GB*?#~4{+r$x^PauG5>AEkFE9kC)Y#>vS4qw}gt|9Yq~f{%i-Dk?9"
    "j&=liWeF4%ZdO1IQ#q1$iL!9=(R}bL73x<i=dVU77`~8DkMZp=#~)GI^mLM7rFrvooF#d4|guYY{"
    "k2B^6!Zj>`+#J87ip&PI#fckXd%TuDJY?<3SY0pyV;_EIQ!_O`T37gz3wY#fp8qa`jJ-&^wk3z;K"
    "oe0qX-ASXz~0R006%<%3^jnevFu7Uldw&zO4JNSE5X`b9|ovZ??8Rb};?1{-!6R;{)}gI<q|*&#?"
    "2{Ty9BkIk^6EFN6!f3^Fk{^0le8<rBf(*OVfj<ErR7mz>N>t8zKZIJ(P=WuDjr`0C~=@WclbLZG1"
    "tUEkp-*BtR;}X7#+{UEsisv%`K_Bnz%W|xAvce<)v;e73l?`+T1Y<oin<;u7)#}TbvV6m{n{#+!$"
    "K!^{iuFcIHtMUNR?LO3#T24#gpZ@Q*gm8e>)V<gQS8ia`&u&-3A4)i((V=X#b91av~o63XK4Tchr"
    "3i15*?+T7RbA~6CN^zjomM+wr@TAjS3cy?Orfo=xmhf6idI$!w?%dV^0785Khc*fw$EMRe@@1ayF"
    "&q-G87*G_tQ(l+($p_eS#=J<}T2RmN>&_Vf2SNvn&@dl=op2C2tm"
)

GEAR_TABLE: tuple[int, ...] = struct.unpack(
    "<256Q", base64.b85decode(_GEAR_B85)
)
