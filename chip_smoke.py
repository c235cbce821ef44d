#!/usr/bin/env python3
"""Smoke run of seaweedfs_tpu_torch on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--seed N]

1. Builds both Hopper kernel libraries from this checkout with nvcc, one
   process per source, and the CRC32-C library (csrc/crc32c.cc), the
   native plane (csrc/http_plane.cc), its load generator
   (csrc/loadgen.cc) and the native codec (csrc/seaweed_ec.cc) with the
   host C++ compiler, all started together
   (csrc/gf_matmul.cu, K1;
   csrc/gf_bitplane.cu, K6a/K6b), and prints each build's time and ptxas
   report (registers, spills, stack frames, wgmma serialization). Counts,
   in the bit-plane library's SASS (cuobjdump), the warpgroup MMA
   (HGMMA/IGMMA), TMA load (UTMALDG) and legacy MMA (HMMA/IMMA)
   instructions, and fails unless there is warpgroup MMA and no legacy
   MMA.
2. Holds K1, run from its tile plan (ops/gf_plan.make_plan, built once
   per matrix), byte-identical to its plain PyTorch version on the card
   over encode matrices for RS(10,4), (6,3), (20,4) (vandermonde and
   cauchy), 4-loss decode plans for (10,4) and (20,4), a (1,10)
   single-row plan and a (128,640) matrix, at widths 1, 129, 4407, 8 MiB
   and 8 MiB + 1, plus a misaligned base pointer; then over the
   piggyback RS(10,4) emat (128,320), its (0,7,11,12) and (1,6,10,11)
   decode plans and the RS(20,4) emat (128,640), at widths 1, 129, 4407,
   262,144 (the piggyback slab, K1's vector path), 262,145, 8 MiB and
   8 MiB + 1; then over the repair legs' two matrices, the trace-repair
   combine (8, total_bits) of a seeded lost shard at its byte-stride
   widths (1 MiB, 1 MiB + 1, an odd tail) and the plane-repair matrix
   (32,176) of a seeded coupled data shard at w/32 (262,144, 262,145, an
   odd tail), each also from a misaligned base. Every plan is built by
   ops/gf_plan.make_plan. Then times K1 (plan built beforehand; its
   build time printed on its own line, outside the timed window) and the
   plain version with CUDA events at the main path's shapes: the flat
   encode and the (0,1,2,3) decode plan (4,10) x 8 MiB, the piggyback
   emat and its (0,7,11,12) decode plan (128,320) x 262,144, the trace
   combine at 1 MiB and the plane-repair matrix at 262,144, beside the
   memory bound and the previous kernel's time. K1 is timed in two
   passes over the shapes; the second is reported, the first printed
   beside it.
3. Holds every bit-plane variant (K6a int8/bf16/tf32, K6b u=2,4 x
   int8/bf16) byte-identical to its plain version and to K1, and K1 to
   its own plain version, over the same geometries at widths 1, 129, 4407,
   262,145 (and 8 MiB for the flat shapes), plus a misaligned base
   pointer; then over the four piggyback geometries at widths 1, 129,
   4407, 262,144 and 262,145.
4. Runs the port's kernel_exp (seaweedfs_tpu_torch/tools/kernel_exp.py) at
   (4,10) x 8 MiB and (128,320) x 262,144: K1 (from a plan built
   beforehand) and every variant's time per launch, chained rate and r^2,
   bound (the function's own: the bytes, or a multiply-add per one of the
   lift), dense bound (the whole lift the TPU kernel multiplies), tile
   bound (the lift tiles the kernel keeps) and tiles kept, and exactness
   against the numpy oracle, each variant beside its previous kernel's
   time (PREV_BP_MS); the
   variants' launch counts are read from this phase. As a yardstick for
   the tensor-core loop only, it times the product alone at both shapes
   (no unpack, no pack): torch._int_mm of the lift by planes stored
   (n, 8k) and passed transposed (column-major B), and torch.matmul of
   the same in bf16.
5. Drives the main path through the port's entry points: writes a
   seeded VOLUME_BYTES volume (.dat with a real superblock, a matching
   .idx), builds the .ecx with write_sorted_file_from_idx, encodes it
   with write_ec_files on the default codec (cuda, pipelined), deletes
   data shards 0-3 and rebuilds, then deletes a seeded 4 of the 14 and
   rebuilds again; every shard must come back sha256-identical, parity
   must agree with the numpy oracle on sampled columns, and the kernel's
   launch counter and the dispatch counters must show the path ran on
   the kernel.
5b. The host's native codec (ops/rs_native, native_leg), between the
   flat encode and its trace: get_codec(10, 4, "native") and K1's codec
   encode the same .dat in turn, native, K1, K1, native (ENCODE_ORDER),
   each over a hard link in a directory of its own with write_ec_files
   and the same 8 MiB slab, both codecs built before the timing; every
   encode's shards must be sha256-identical to step 5's, a native encode
   may launch no K1 and a K1 encode one a slab. Prints, beside the card
   line and the host's core count, each encode's wall and MB/s of .dat,
   each codec's MB/s on its mean wall and their ratio, the main path's
   first K1 encode, and the native product alone on one (10 x 8 MiB)
   slab at one thread and at every core against K1's time at (4,10) x
   8 MiB from step 2; get_codec(10, 4, "auto") must resolve to the
   card's TorchCodec.
6. Traces one more encode and one more rebuild of the same volume with
   torch.profiler and reports the card's busy share of their wall time
   (the union of kernel, copy and memset intervals on the device) and
   the kernel's time per launch as it ran inside the pipeline.
7. Encodes the same volume again with layout="piggyback", writes the
   layout sidecars, checks them (.vif geometry, the .ecx tag byte), the
   data shards (equal to flat), the parity (numpy oracle on three
   windows) and the counters, then rebuilds (0,7,11,12) and a seeded 4
   of the 14 through volume_layout; every shard must come back
   sha256-identical with launches = dispatches.
8. The rebuilder's repair paths on the same volume, through the gather
   sources (window 4, 8 MiB stripes). Between the flat legs and the
   piggyback encode: trace repair of the seeded lost shard
   (LocalRepairReader per plan helper, RepairGatherSource,
   rebuild_ec_file_repair; repair_bytes = total_bits x sum ceil(w/8), the
   plan's fraction of k x shard) and a streaming rebuild of a seeded 4
   (LocalShardReader over the first k survivors, StripedGatherSource,
   rebuild_ec_files_streaming; peak_gather_buffer within window x k x
   8 MiB). After the piggyback legs: plane repair of the seeded coupled
   data shard (LocalPlaneReader, PlaneGatherSource,
   rebuild_ec_file_piggyback; exactly 0.55 of k x shard) and a streaming
   piggyback rebuild of a seeded 4 (readers in piggyback_decode_plan's src
   order). Every shard must come back sha256-identical, each leg with
   dispatches = launches and one plan upload.
9. ec.decode: find_dat_file_size and write_dat_file from the data shards
   must give back the original .dat's first dat_size bytes, and
   write_idx_file_from_ec_index the .ecx records (the piggyback tag byte
   dropped) plus a tombstone for each id of a written .ecj.
10. Degraded reads and the scrub, on each layout (after the flat
   streaming rebuild, and after the streaming piggyback rebuild). K1 is
   first held against its plain version on their four products: the
   flat lost row (1,10) of a seeded data shard at 1,179,648 (a needle
   batch: 8 slabs + 1 readahead slab) and 16,908,288 (the wide read),
   the shard's alpha rows of the coupled decode plan (32,320) at 557,056
   (17 windows over 32), the syndrome rows (4,14) at 1 MiB and the
   piggyback ones (128,448) at 32,768, each +1, an odd tail and from a
   misaligned base; then timed at those widths (gf_matmul_degraded,
   gf_matmul_scrub in the kernels line). The degraded leg moves the
   seeded data shard aside, mounts EcVolume over the rest with a
   DegradedReadEngine (defaults: 128 KiB slabs, 2 ms batches, 1 slab of
   readahead, 64 MiB cache), serves DEGRADED_GETS needle GETs
   (PB_DEGRADED_GETS on the piggyback layout, cut from 48 to 24 to keep
   the smoke within its time with step 15 beside it) whose
   intervals touch the lost shard from 4 threads through
   read_needle_blob(nid, reconstruct_fetch=engine.read), each blob held
   against the .dat, then one 16 MiB read of the lost shard with the
   cache emptied, held against the shard; it prints the GETs' p50/p99,
   the wide read's MB/s and the engine's counters and batch phases, and
   needs launches = device dispatches >= 1 (on the piggyback layout the
   needle batches fall below the crossover, so the wide read carries
   K1). The scrub leg runs ScrubEngine.scrub_volume(force=True) unpaced:
   a clean pass, then a pass with one seeded byte of a seeded shard
   flipped, which must report exactly that slab and that shard; the
   byte is put back and the shard's sha256 checked.

11. EC repair over the network, on the same volume: after the flat
   scrub, three holder processes (python3 -m
   seaweedfs_tpu_torch.server.volume_server) on 127.0.0.1 over
   directories of hard links to the .ecx, .vif and shards (A 0-4, B 5-9
   plus 0 and 1, C 10-13), and the rebuilder a Store over an empty
   directory (codec TorchCodec on the card), which fetches the index
   sidecars over /admin/file. Net trace repair of the seeded lost shard
   with -repair auto (the trace route, exactly the plan's symbol bytes
   over HTTP: 0.6875 of k x shard for shard 10); a net full rebuild of
   the streaming leg's seeded 4 (-repair auto falls back, with its
   reason, to the full streaming decode: k x shard over HTTP); net
   degraded GETs with every survivor remote (an EcVolume over a
   directory with only the .ecx and .vif, the location map listing no
   holder for data shard 1, NET_GETS GETs from 4 threads and a 16 MiB
   read, each held against the .dat and the shard); a net scrub with
   shard 0 local and 1-13 on the holders (a flipped byte of a seeded
   remote shard found in its slab and shard). After the piggyback scrub,
   holders over the piggyback shards and a net plane repair of the
   seeded coupled data shard (exactly 0.55 of k x shard over HTTP). Each
   rebuilt shard must be sha256-identical, and each rebuild's fetches
   per holder exactly what rotation by stripe gives (so both holders of
   shards 0 and 1 served them), with no retry. The holders are stopped
   in a finally; one that does not start fails the run.

12. ec.encode over the network, on each layout (after the flat net legs,
   and after the piggyback net plane repair): an in-process source
   VolumeServer on the card over hard links to the volume's .dat and
   .idx (its own directory; the original's size and sha256 are checked
   unchanged after), three holder processes over empty directories
   (started with the net legs' holders before them, so that one wait
   covers both groups' start-up).
   POST /admin/volume/readonly, then /admin/ec/generate with the
   assignment (source shards 0-1, A 2-5, B 6-9, C 10-13, no spares, the
   default window), traced for the card's busy share; the source encodes
   on K1 and pushes each shard's 8 MiB stripes to its holder over
   /admin/ec/shard_write while later stripes encode. Each holder then
   runs /admin/ec/copy (the .ecx and .vif) and /admin/ec/mount. Every
   shard must be sha256-identical at its holder to the local encode of
   the same layout, no .part left anywhere, 12 shards remote, sends only
   to the assigned holders, spread_bytes 14 x shard, exactly 12 x shard
   in the holders' files, which started
   empty, and every assigned shard mounted. Prints the leg's wall,
   encode_busy_s, spread_busy_s, overlap_frac, peak_spread_buffer and
   blocked_s (stream_s - encode_busy_s) on a line of its own.

13. The needle data plane of a port volume server, after ec.decode. A CRC
   phase first holds the compiled CRC32-C (storage/crc.py) against its
   plain version on seeded inputs of 0, 1, 7, 8, 4097 and 1 MiB + 3
   bytes (whole, chained, and its slicing-by-8 path) and prints both
   rates. Then an in-process VolumeServer on the card (127.0.0.1, an
   empty directory, RS(10,4), flat): /admin/assign_volume; four client
   threads POST seeded needles as multipart uploads, in the plan's
   order (each prepares its body, then waits until the previous POST
   is answered, so the .dat layout, and with it the needles on shard 1,
   is fixed by the seed), until their data
   fills DATA_PLANE_BYTES (64 MiB: the leg was cut from VOLUME_BYTES to
   keep the smoke's time with steps 14-16 beside it; sizes log-uniform
   over 1 KiB-4 MiB, about 130 needles; each named, a third with a mime, a third octet-stream, every
   fifth with a Seaweed-* pair; the reply's name, size and ETag checked,
   each fid's sha256 kept); every needle GET back (sha256 and ETag);
   every tenth DELETEd and 404 after; the vacuum (check > 0, compact,
   commit, check 0; the .dat shrinks by exactly the deleted needles'
   actual sizes; every live needle read back); /admin/volume/readonly,
   the query form of /admin/ec/generate, /admin/ec/mount and
   /admin/delete_volume, in ec.encode's order (K1 launches = the
   encode's dispatches = ceil(shard / 8 MiB)); every live needle GET from
   the EC volume (no launch); /admin/ec/delete_shards?shards=1; the
   needles whose intervals touch shard 1 GET from four threads, each
   parsed and its CRC checked by the server, through the server's
   DegradedReadEngine (launches = its device dispatches > 0; p50, p99);
   the query form of /admin/ec/rebuild (launches = its dispatches; shard
   1 sha256-identical to the one encoded) and the shard's mount, then
   the same GETs with no launch; three EC DELETEs, each 404 after and
   listed in the .ecj. Prints write MB/s and requests/s, read MB/s, the
   vacuum's, the encode's and the rebuild's seconds and the degraded
   p50/p99, each on a line of its own, then the leg's numbers as JSON.

14. A port cluster, after the data plane: three in-process
   MasterServers in a raft group (127.0.0.1, ports picked free
   beforehand, 1 s pulses, each its own raft directory and draws seeded
   from --seed, one write-token key drawn from --seed, the whitelist
   127.0.0.1), one leader awaited and its seconds printed; volume server
   A in-process on the card (20 slots), B as a python3 -m
   seaweedfs_tpu_torch.server.volume_server --master process (8 slots),
   each given the three masters with the leader first, the key and the
   whitelist. Clients and the shell talk to a follower F, so every
   assign, lookup and shell command is forwarded to the leader;
   one 001 volume grown with /vol/grow while only A and B are
   registered, so its replicas are on both; then C and D as processes,
   which start while the writes run and must have registered before the
   encode. Four client threads assign (client/operation) and POST seeded
   needles (the data plane's plan: log-uniform over 1 KiB-4 MiB until
   CLUSTER_BYTES, 32 MiB, cut from VOLUME_BYTES to make room for steps
   15, 16 and 19 and the volume control plane within the smoke's time) to the
   server /dir/assign names, which fans each out to
   the other replica, each POST with its assign's token; each reply's
   size and ETag checked. Every needle
   GET back from A and from B (the locations of /dir/lookup) and through
   F's GET /<fid> (a 301 to the leader, checked once, then a 301 to a
   holder), sha256 and Etag; a POST to A without a token and one with
   another fid's token, each 401; a full backup
   (command/volume_tools.backup_volume); every tenth DELETEd through the
   client with GenJwt(key, fid), 404 on A and B after. The volume
   control plane: an incremental backup, which must ship exactly the
   tombstone records (its bytes checked) and hold every live needle
   sha256-identical and every deleted one gone; volume.vacuum below the
   deleted share, which must name the volume vacuumed, leave the master
   no deleted bytes on either replica, and shrink A's and B's .dat by
   exactly the deleted needles' records plus their tombstones (each
   .dat walked before),
   every live needle then GET sha256-identical from A and B and every
   deleted one 404; volume.fsck -deep (each replica checks every live
   needle, 0 errors); volume.move -source B -target C (/dir/lookup
   lists A and C, no file of the volume left on B, every live needle
   sha256-identical from C). C is the second replica from there. Both
   replicas frozen, A's compacted .dat linked aside, then ec.encode
   -volumeId through the port shell (it must stream from A; a shell line
   that reports an error or a fallback to copy mode fails the leg): 14
   shards over A-D in /cluster/ec_status, each sha256-identical to a
   local write_ec_files of A's frozen .dat through K1's plain version on
   the card (no launch), the volume gone from A and C, K1 launches on A
   = the encode's dispatches; the encoded .dat's size printed beside the
   pre-vacuum one. The process of B-D with the most shards is
   killed (SIGKILL) and the master's prune awaited (at most
   PRUNE_WAIT_S); the live needles touching its shards GET from A by
   four threads through A's DegradedReadEngine (launches = its device
   dispatches > 0; p50, p99). Failover: the leader stopped (its HTTP
   server and its raft, no hand-off); the seconds until one of the two
   survivors leads, both survivors' /cluster/status naming it with its
   peers, the servers registered with it (A and the processes follow the
   leader hint of a follower's heartbeat answer), and its
   /cluster/ec_status equal to the old leader's after the prune (the
   killed holder absent); a /vol/grow into CLUSTER_COLLECTION-ids and
   ID_ASSIGNS assigns through F: the new volume id above every earlier
   one, every new file key above every key assigned before the failover.
   Then, under the new leader, ec.rebuild through F (on A: launches =
   dispatches > 0, every rebuilt shard sha256-identical). (b) That
   rebuild is one trace: its id the newest trace on A whose root is the
   shell's ec.rebuild span; trace.export -trace <id> through the port
   shell merges its spans from every node (this process's trace ring and
   the processes'): the shell's root, the new leader, A with at least one
   dispatch span, each peer that served a shard read, every event under
   the one id with no negative ts or dur; cluster.profile -seconds 0.2
   gathers stacks from every master and server it names. Then
   ec.balance
   (14 shards mounted, each sha256-identical where it lies); every live
   needle read through the live servers in turn, with no launch on A;
   ec.decode, then every live needle through /dir/lookup and the volume out of
   /cluster/ec_status. Its one replica unmounted and mounted again (a
   needle 404, then sha256-identical), volume.fix.replication (two
   holders in /dir/lookup), volume.fsck -deep on both (0 errors), every
   live needle sha256-identical from the new replica; four needles
   through the master's /submit into CLUSTER_COLLECTION-tmp, each read
   back; collection.list shows both collections; collection.delete of
   the second: its volumes off every live server's /status and out of
   /dir/lookup, the first untouched. Prints
   the write MB/s and requests/s, the read MB/s, the walls of ec.encode,
   the prune wait, ec.rebuild, ec.balance and ec.decode, the vacuum's
   seconds and bytes reclaimed, fsck -deep MB/s, move and
   fix.replication MB/s, the backups' bytes and seconds, the degraded
   p50/p99 and the K1 launches by step, each on a line of its own, then
   the leg's numbers as JSON, with the two elections' seconds, the
   re-registration's, the requests forwarded through F and the key and
   volume-id margins. Every process is stopped and every
   directory removed in a finally. The masters run no repair loop, no
   vacuum loop and no maintenance scripts (CPU tests hold those: a loop
   firing inside the leg would race its commands).

15. The integrity plane of a port cluster, after step 14, on the main
   volume (its .dat and .idx hard-linked into A's directory before
   A starts): an in-process MasterServer with a repair loop every
   INTEGRITY_REPAIR_S, A in-process on the card, B and C as processes on
   the card (INTEGRITY_SLOTS: B the freest, so the shell puts shard 0 on
   it), scrubs unpaced. The master and B and C start with the piggyback
   spread leg's holders, so their start-up overlaps the legs before.
   ec.encode through the shell from A; volume.ec.scrub -trigger: no
   finding on any server, no open incident, and each server's K1
   launches, read from its own GET /admin/devices delta, equal its
   scrub's device dispatches, > 0. One byte flipped mid-shard in a seeded
   shard of B's; /admin/ec/scrub?volume= on B names that shard and no
   other, its K1 launches (B's /admin/devices delta, the master's drain
   held until it is read) = its device dispatches; the master's queue
   opens one corruption incident at priority 0 and its drain posts
   /admin/ec/scrub_repair to B, which rebuilds on K1 (B's
   /admin/devices delta = the rebuild's stripes, > 0); the shard
   sha256-identical to the main path's; the incident resolved via
   scrub_repair with its time to re-protection; a second scrub of B
   clean. /admin/ec/delete_shards removes a seeded shard of C's; the
   heartbeat reports it, the scan opens a lost_shard incident, and the
   drain rebuilds and mounts it on the holder of shard 0 (asserted: B),
   on K1 there (delta = stripes); sha256-identical, resolved via
   rebuild. Then a server built with degraded_mode="naive" (in-process,
   no master, over hard links to every shard but a seeded data shard)
   serves INTEGRITY_GETS needle GETs (GET /<fid> over HTTP) through that
   shard from DEGRADED_THREADS threads, each body = the needle's data in
   the .dat, its K1 launches = the ranges it reconstructed. cluster.repairs and
   cluster.devices through the shell, printed; no incident open but
   at-risk-holder advisories, which the master's health fold may open on
   a loaded host (printed; advisory, never drained). (c) The fleet
   scrape: each server's GET /metrics parses with
   stats/metrics.parse_prometheus_text, and its
   SeaweedFS_volumeServer_ec_xla_dispatches_total{entry=
   "rs_hopper.gf_matmul"} equals the K1 dispatches of its /admin/devices
   (read before and after), which equal its launches; the master's
   /cluster/metrics?refresh=1 series is their sum; /cluster/health
   ?refresh=1 lists every server fresh, its repairs fold the times to
   re-protection /cluster/repairs gives (at least the two incidents').
   Prints each step's wall on a line of its own, then the leg's numbers
   (scrub MB/s per server, detect-to-resolve seconds of both incidents,
   K1 launches by server, the fleet scrape) as JSON.

16. The multi-device tier, after step 15 and before the decode leg
   rewrites the .dat, on the main volume. Two
   rank processes start first (each one position on the card, joined
   over gloo: NCCL refuses two ranks on one device, and the smoke prints
   that reason) and wait while (a) and (b) run. (a) MeshCodec over
   make_codec_mesh([cuda:0, cuda:0]), two 'data' positions on the one
   card: write_ec_files (pipelined, 8 MiB slabs, each split into two
   4 MiB lanes staged, copied and launched on their own streams) into a
   directory over a hard link to the .dat, all 14 shards sha256-equal to
   step 5's; then a seeded 4 removed and rebuilt (pipelined, a piece per
   position), sha256-identical. Each must show mesh dispatches = slabs,
   width 2, busy 1.0 at both positions, one plan upload and K1 launches
   = 2 x sharded dispatches; MB/s printed. A (10, 4096) product crosses
   over to one position (no mesh dispatch, width 1). (b)
   distributed_ec_step(k=10, m=4, n_per_device=8 MiB) on a (2,2) mesh of
   four positions on the card: diff 0, 8 K1 launches (the rebuild's two
   (4,5) partials per column block XOR-folded), the parity equal in full
   to TorchCodec's single-device output and to the numpy oracle on
   sampled columns. (c) The ranks run multihost_ec_step(n_per_device=8
   MiB) on their (1,2) mesh, their partials all-gathered through pinned
   host memory and XOR-folded; each rank's summary must be ok, with its
   own K1 launches (2, from its own ops/device_stats, reset just before)
   and the card's name. K1 is first held against its plain version at
   step 16's shapes ((4,10) at a 4 MiB lane, +1, a misaligned base; the
   two (4,5) decode blocks at 8 MiB) and timed there (gf_matmul_mesh in
   the kernels line).

17. (a) The small-dispatch tuner on the card, after the flat scrub leg:
   a fresh stats/metrics.SmallDispatchTuner and TorchCodec(10, 4) on the
   card, ops/codec.SMALL_DISPATCH_AUTO on for the leg only (restored, with
   the tuner and the crossover, in a finally). Reconstructs of four lost
   shards (TUNER_LOST) at six widths from 256 KiB to 8 MiB (one K1 launch
   each) and then six below 64 KiB (the host, no launch; below any
   crossover the tuner can install), two rounds, each output held
   against NumpyCodec's encode of the same seeded data. Each reconstruct
   span gives the tuner its width and seconds, and its fit goes live:
   dispatch_threshold must then equal the suggestion, and a reconstruct
   one byte below it launch no K1 and one at it exactly one (the auto
   constant off for those two, so their own samples move nothing).
   Prints the crossover, the host MB/s and the device line's intercept
   and slope, the first crossover of K1 measured on the card. The card
   wins at every sampled width, so the crossover must be the tuner's
   floor, 65,536 B, whatever the sign of the fitted intercept.

18. The f4 hot→warm lifecycle, after step 14: an in-process MasterServer
   (its tierer capped at TIER_RATE_MBPS, age 0) and TIER_SERVERS
   in-process VolumeServers on the card. (a) The dir tier: a 000 volume
   of TIER_DIR_NEEDLES seeded 64 KiB needles through volume.tier.upload
   -dest dir.cold (the port shell) onto a dir backend of the card's host:
   the .dat gone, the object byte-equal to it; every needle GET through
   the master (served by the RemoteFile's range reads) equals its write;
   a cold DiskLocation reopen serves each again; volume.tier.download
   -deleteRemote restores a .dat whose sha256 is the original's and
   empties the tier; the volume thawed. (b) A demotion on K1 under
   foreground traffic: a 001 volume filled with seeded 64 KiB needles
   (TIER_BYTES: a 30 GiB production volume cut for the smoke's time) and
   sealed on both holders, the source's .dat linked aside; TIER_READERS
   readers (GETs through the master's lookup) and TIER_WRITERS writers
   (8 KiB needles into the default collection) through a healthy window
   as long as the cap's floor, then the same load through GET
   /cluster/tiering?scan=1. It must end warm with demotions_ok 1, no read
   or write failed or differed and reads ran inside the demotion, no
   write landed in the sealed volume, every needle after the flip equals
   its write, the hot replicas are gone and /cluster/ec_status lists the
   volume, each of the 14 shards has the sha256 of the kept .dat encoded
   through K1's plain version on the card (no launch), K1's launches on
   the source (its /admin/devices) equal its dispatches and are > 0, and
   the master's /metrics shows one ok demotion, hot_bytes demoted and one
   warm volume. Prints the demotion's wall and MB/s under the cap, read
   p50/p99 healthy and during, write p50/p99, overlap_frac and the trace
   id, then the leg's numbers as JSON.

19. The native data plane, after step 13 (native_plane_leg): an
   in-process master and a port VolumeServer on the card with its plane
   (csrc/http_plane.cc, built with g++ beside the kernels, as is
   csrc/loadgen.cc) on a second port; needle sizes from step 13's plan
   (seed --seed). (a) The plane is up and built from this checkout's
   sources. (b) loadgen POSTs to the plane over batch-assigned fids, under
   the sync mode off and then group (set_sync_mode, the lease cycled),
   NP_SECONDS or NP_POST_BYTES each, every 200 a fresh needle: every
   written needle read back sha256-identical; group: every acknowledged
   write a rider of a committed batch, an fdatasync timed per batch, none
   pending or failed. (c) loadgen GETs of those needles through the
   plane, then through the Python server. (d) JSON needles added, the
   volume encoded (launches = dispatches) and shard DATA_LOST deleted;
   NP_COLD_GETS needles touching it (their lost slabs disjoint) GET cold
   through the plane, each a 307 then reconstructed on K1 (launches = the
   engine's device dispatches > 0), then warm, each served by the plane
   from its slab cache (no launch, no Python read, hits). (e) A file of
   three chunks and a manifest, read whole and by Range, deleted with its
   chunks. (f) /query over the JSON needles through the lost shard, rows
   equal to a plain filter of the documents. (g) A -index disk server's
   needles, written by its plane, read back after a cold restart. Prints
   req/s, MB/s, p50 and p99 of each loadgen run, the group commits and
   riders, cold and warm p50/p99, K1 launches and cache hits, then the
   step's numbers as JSON.

20. The filer and the S3 gateway, after step 18 (s3_leg): the stack a
   user starts, python3 -m seaweedfs_tpu_torch.command.cli server -filer
   -s3 -s3Config <iam.json> -tierConfig <tier.json> -ec.backend cuda in a
   process of its own (S3Stack, spawned before step 14 so that its
   start-up overlaps it) on free ports, its volume server on the card
   with its native plane, its master's repair loop off
   (SW_REPAIR_INTERVAL_S=0). (b) With one IAM identity and the port's
   SigV4 signer: a bucket, S3_OBJECTS objects of S3_MIN–S3_MAX from a
   plan seeded by --seed (about S3_BYTES), a multipart upload of
   S3_PARTS, a CopyObject, ListObjectsV2 by prefix and delimiter, HEAD, a
   ranged GET across a part's edge and DeleteObjects of S3_DELETED keys:
   every ETag the body's MD5 (the multipart form for the upload), every
   GET sha256-identical, a deleted key 404 NoSuchKey, and the filer's own
   GET /buckets/<bucket>/<key> the same bytes. (c) ec.encode of every
   volume of the bucket's collection (the port shell), then the shard
   that the most objects' needles cross (from each .ecx, ec/locate)
   removed and unmounted; every object GET again, cold then warm: K1's
   launches in the stack's process (its /admin/devices) over the cold
   pass > 0 and equal to the degraded engine's device dispatches. (d)
   ec.rebuild: the shard sha256-identical to the lost one, every object
   again. (e) A small sealed volume onto the s3 tier whose endpoint is
   the stack's own gateway (volume.tier.upload -dest s3.self), its
   needles read remotely, downloaded back, every byte equal. SIGTERM then
   exit 0. Prints PUT and GET MB/s and p50/p99 (healthy, cold, warm), the
   objects crossing the lost shard (and by at least S3_MIN), K1 launches
   by phase, the plane's redirects and slab-cache hits, and the step's
   numbers as JSON.

21. A mutual-TLS cluster from config files, after step 20 (mtls_leg):
   (a) a CA, a server certificate (CN 127.0.0.1) and a peer certificate
   it signed, and a self-signed rogue one, made with the openssl CLI (a
   missing openssl fails the step). (b) python3 -m
   seaweedfs_tpu_torch.command.cli server -filer -ec.backend cuda started
   in a directory that holds only security.toml ([https] cert, key, ca,
   mutual = true; [jwt.signing] key) and master.toml
   ([master.volume_growth] copy_1 = MTLS_GROWTH; no maintenance), and two
   volume -ec.backend cuda processes given the same material by -tlsCert,
   -tlsKey, -tlsCa, -tlsMutual (and -jwtKey), b with -index compact and c
   with -index sortedfile (MTLS_INDEX), all spawned with step 16's
   ranks (MtlsCluster); the master's repair loop off
   (SW_REPAIR_INTERVAL_S=0), every scrub's first pass due after the step
   (ec/scrub.IDLE_S). This process is a client with the peer certificate
   for the step. (c) Refusals: plain http:// to the master gets no
   answer; /cluster/status and each volume server's /admin/devices
   answer 403 without a client certificate; the rogue certificate fails
   the handshake; a public fid GET over server TLS answers 200; no
   volume server runs a native plane. (d) One MTLS_COLLECTION volume
   grown in each server's data center (MTLS_DC, /vol/grow), so the
   placement is the same every run; benchmark -n MTLS_BENCH_N
   -size MTLS_BENCH_SIZE -c 8 -collection MTLS_COLLECTION, upload of
   MTLS_FILES files of 256 KiB-4 MiB (about MTLS_BYTES, seeded by
   --seed) and filer.copy of a small seeded tree, each a CLI process in
   the config directory; download (the CLI's command, one call a file)
   sha256-identical; the filer's HTML listing names every copied file;
   the master's /ui names the three volume servers and a volume server's
   /ui lists its volumes. weed shell's volume.move (a process) moves
   the volume most uploaded files sit on among those off c onto c, and
   every volume of c is unmounted
   and mounted again: each must then have a .sdx whose .sdx.meta
   watermark covers its .idx, and every download after reads through
   it. (e) ec.encode -collection through weed shell,
   a process in the config directory (a TLS client itself); the shard
   the most uploaded files cross (each .ecx, ec/locate) removed and
   unmounted (no .sdx or .sdx.meta of an encoded volume may be left on
   c); every file downloaded cold then warm, sha256-identical:
   K1's launches in the holders' processes over the cold pass (their
   /admin/devices, read with the peer certificate) > 0 and equal to
   their degraded engines' device dispatches, the survivors pulled from
   other holders over /admin/ec/shard_read. (f) ec.rebuild: the shard
   sha256-identical to the lost one, >= 1 K1 launch; every file again.
   (g) SIGTERM, then exit 0. Prints the benchmark's write and read
   req/s, MB/s, p50 and p99, download MB/s, p50 and p99 (healthy, cold,
   warm), K1 launches by phase, connections each client's pool opened,
   and the step's numbers as JSON.

22. The filer's event plane and gateways, after step 20 (event_leg) on
   its stack, kept up: S3Stack also runs -webdav -webdavPort, and its
   filer's webhook publisher (WEED_NOTIFICATION_WEBHOOK_ENABLED and _URL
   in its environment, no notification.toml) posts every metadata event
   to a msgBroker process's /queue/publish?topic=EVENT_TOPIC; the broker
   and watch -filer <filer> -since 0 are processes started with step 16's
   (EventPlane). (a) A text object of EVENT_TEXT_BYTES PUT through S3;
   the shard that the most of step 20's objects cross, other than step
   20's, removed and unmounted. (b) filer.replicate, a process, from the
   filer's last event on, source /buckets/<bucket>, an s3 sink to bucket
   REPLICA_BUCKET on the stack's own gateway, seeded by a shell process's
   fs.meta.notify of the bucket: every object in the replica, each
   replica GET sha256-identical to its PUT; SIGTERM, exit 0. (c) WebDAV:
   PROPFIND depth 1 lists the bucket's children as the filer does, every
   object GET sha256-identical, one ranged GET equal to its bytes; MKCOL,
   PUT of EVENT_DAV_BYTES, MOVE, COPY, LOCK, a PUT refused 423 without
   the token, UNLOCK, DELETE, a 404 after. (d) One shell -filer process:
   fs.ls and fs.du of the bucket, bucket.list, bucket.create,
   bucket.delete, fs.meta.save of the bucket and fs.cat of the text
   object, its whole output equal to what the filer holds, fs.cat
   sha256-identical. K1's launches in the stack's process over (b)-(d)
   (its /admin/devices) > 0 and equal to its degraded engine's device
   dispatches. (e) The broker topic's messages equal /filer/events since
   0, key for key and in order; watch's lines equal format_event of the
   same events (SIGTERM, exit 0); the broker exits 0, and the stack.
   Prints the replication's wall, MB/s and GET p50/p99, WebDAV GET MB/s
   and p50/p99, the shell's wall, the event counts, K1 launches, and the
   step's numbers as JSON.

Every leg runs with every kernel's launch count (ops/device_stats) set
to 0 just before it and read just after; a leg of steps 5-8 and 10-19
whose K1 launches in this process differ from its dispatches (two for a
dispatch sharded over step 16's two positions; step 16 (b)'s programs
count eight launches and no codec dispatch), or that launched nothing,
fails the smoke; step 5b's host codec must launch nothing. Each leg's
wall is printed. Every
volume server the smoke starts, in its process or as a process, runs
with its background scrub off (scrub_idle_s 0): a scrub runs only when
a leg asks for it.

Prints the card line (nvidia-smi name, power limit), then a JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}. Exits non-zero,
printing no result, if any phase fails or no CUDA device is present.
Working files live under seaweedfs_tpu_torch/build/smoke/ and are removed.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import math
import os
import queue
import select
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
VOLUME_BYTES = 384 << 20    # BASELINE.json config 1 (30 GB default cut)
MAIN_N = 8 << 20            # main-path slab width (encoder DEFAULT_SLAB)
ENCODE_ORDER = ("native", "k1", "k1", "native")  # step 5b's encodes
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
L2_BYTES = 50 << 20         # H100 SXM L2
WIDTHS = (1, 129, 4407, MAIN_N, MAIN_N + 1)
PB_N = 262_144              # piggyback slab: 8 MiB over alpha = 32
BP_WIDTHS = (1, 129, 4407, PB_N + 1)  # bit-plane widths; flat shapes add
                                      # MAIN_N
PB_WIDTHS = (1, 129, 4407, PB_N, PB_N + 1)  # the piggyback geometries'
TRACE_N = MAIN_N // 8       # trace combine: a stripe's byte stride
#: the repair matrices' widths: 1 stripe, 1 stripe + 1, an odd tail
TRACE_WIDTHS = (1, 129, 4407, TRACE_N, TRACE_N + 1, 917_503)
PLANE_WIDTHS = (1, 129, 4407, PB_N, PB_N + 1, 229_377)
GATHER_WINDOW = 4           # ec.transport.DEFAULT_WINDOW
DEGRADED_SLAB = 128 << 10   # ec.degraded.SLAB_BYTES
DEGRADED_WIDE = 16 << 20    # the wide range read of a lost shard
DEGRADED_GETS = 48          # needle GETs through a lost shard, flat
PB_DEGRADED_GETS = 24       # piggyback (cut from 48: each batch runs on
                            # the host, ~0.5 s a GET)
DEGRADED_THREADS = 4        # GET reader threads
NET_HOLDS = {"A": range(0, 5), "B": (0, 1, 5, 6, 7, 8, 9),
             "C": range(10, 14)}  # the holders' shards; 0, 1 on two
NET_LOST = 1                # the net degraded leg's lost data shard
NET_GETS = DEGRADED_GETS    # needle GETs of the net degraded leg
SPREAD_LOCAL = (0, 1)       # the spread source keeps these shards
SPREAD_HOLDS = {"A": range(2, 6), "B": range(6, 10), "C": range(10, 14)}
HOLDER_START_S = 60.0       # a holder prints its port within this
DATA_VID = 7                # the data-plane leg's volume
DATA_PLANE_BYTES = 64 << 20  # its needles' data (cut from VOLUME_BYTES)
DATA_MIN = 1 << 10          # its needle sizes, log-uniform between
DATA_MAX = 4 << 20
DATA_THREADS = 4            # its client threads
DATA_LOST = 1               # the shard it loses after the encode
DATA_EC_DELETES = 3         # EC DELETEs at its end
NP_VID = 8                  # step 19's volume (the native plane)
NP_POST_BYTES = 4 * DATA_PLANE_BYTES  # a sync mode's POST data at most
NP_SECONDS = 1.0            # each loadgen run's length at most
NP_THREADS = 8              # loadgen connections (the card's host: 8 cores)
NP_SLOTS = 16               # the step's server's volume slots
NP_COLD_GETS = 48           # lost-shard GETs, cold then warm
NP_WARM_BYTES = 24 << 20    # their slabs, within the plane cache's 32 MiB
NP_JSON_NEEDLES = 12        # JSON-lines needles for /query: 12 MiB in a
NP_JSON_ROWS = 6_000        # row, so one lies on every shard (~1 MiB each)
NP_CHUNK = 1 << 20          # the chunked file's chunk (3 chunks)
NP_DISK_NEEDLES = 64        # the -index disk volume's needles
CLUSTER_COLLECTION = "smoke"  # the cluster leg's collection
CLUSTER_BYTES = 32 << 20    # its needles' data (cut from VOLUME_BYTES)
INTEGRITY_SLOTS = {"A": 8, "B": 10, "C": 8}  # B the freest: shard 0 on B
INTEGRITY_REPAIR_S = 0.5    # the integrity leg's repair-loop period
INTEGRITY_GETS = 32         # its naive degraded GETs
INTEGRITY_WAIT_S = 60.0     # bound on each of its waits
SERVER_DEVICE = "cuda"      # the integrity leg's servers' (a CPU rehearsal
                            # sets "cpu")
CLUSTER_SLOTS = {"A": 20, "B": 8, "C": 8, "D": 8}  # A the freest
CLUSTER_PULSE_S = 1.0       # its heartbeats; the master prunes after 5
CLUSTER_THREADS = 4         # its client threads
PRUNE_WAIT_S = 30.0         # bound on the wait for the prune of a killed one
CLUSTER_MASTERS = 3         # the cluster leg's raft group of masters
ELECTION_WAIT_S = 30.0      # bound on each wait for a leader
ID_ASSIGNS = 16             # assigns after the failover whose keys are held
MESH_LANE_N = MAIN_N // 2   # step 16 (a): an 8 MiB slab over two positions
MESH_STEP_N = MAIN_N        # step 16 (b), (c): columns per mesh position
RANK_START_S = 120.0        # a rank process joins its group within this
MESH_DEVICE = "cuda:0"      # step 16's positions' card (a CPU rehearsal
                            # sets "cpu")
TIER_SERVERS = 3            # the tiering leg's in-process volume servers
TIER_SLOTS = 20             # their volume slots each
TIER_BYTES = 28 << 20       # its sealed volume's needle data (a production
                            # volume holds 30 GiB: cut for the smoke's time;
                            # under 30 MiB of .dat, so 3 MiB shards)
TIER_NEEDLE = 64 << 10      # its needles' size
TIER_RATE_MBPS = 16.0       # the demotion's cap, of shard bytes pushed
TIER_READERS = 4            # foreground reader threads
TIER_WRITERS = 2            # foreground writer threads
TIER_WRITE = 8 << 10        # a writer's needle size
TIER_DIR_NEEDLES = 64       # part (a)'s volume on the dir backend
TIER_WAIT_S = 30.0          # bound on each of its waits
TUNER_DEVICE = "cuda"        # the tuner leg's codec (a CPU rehearsal sets
                             # "cpu"; a card is needed otherwise)
# the tuner leg's widths: below the 64 KiB clamp, so the host path takes
# them whatever crossover the leg installs, and from 256 KiB (the default
# crossover) to 8 MiB, K1 on the card
TUNER_HOST_WIDTHS = (8 << 10, 16 << 10, 24 << 10, 32 << 10, 48 << 10,
                     60 << 10)
TUNER_DEVICE_WIDTHS = (256 << 10, 512 << 10, 1 << 20, 2 << 20, 4 << 20,
                       8 << 20)
TUNER_ROUNDS = 2             # samples a width
TUNER_LOST = (0, 5, 11, 13)  # the reconstructs' lost shards: (4,10)
CRC_SIZES = (0, 1, 7, 8, 4097, (1 << 20) + 3)
SHA_THREADS = 8              # files hashed at once (the card's host: 8 cores)
CRC_PLAIN_BYTES = 1 << 20   # the plain version's timed input
#: K1's widths on the degraded legs: a flat needle batch (1 MiB of a
#: needle in 8 slabs + 1 readahead slab), the flat wide read (16 MiB + 1
#: readahead slab) and the piggyback wide read (its 17 windows over 32)
NEEDLE_N = 9 * DEGRADED_SLAB
WIDE_N = DEGRADED_WIDE + DEGRADED_SLAB
PB_WIDE_N = 17 * (1 << 20) // 32
SCRUB_N = 1 << 20           # ec.scrub.SLAB_BYTES; piggyback: over alpha
PB_SCRUB_N = SCRUB_N // 32
DEGRADED_WIDTHS = (1, 129, 4407, NEEDLE_N, NEEDLE_N + 1, WIDE_N, WIDE_N + 1,
                   655_359)
PB_DEGRADED_WIDTHS = (1, 129, 4407, PB_WIDE_N, PB_WIDE_N + 1, 98_303)
SCRUB_WIDTHS = (1, 129, 4407, SCRUB_N, SCRUB_N + 1, 786_431)
PB_SCRUB_WIDTHS = (1, 129, 4407, PB_SCRUB_N, PB_SCRUB_N + 1, 24_575)
#: K1's time per launch before the tile-plan redesign, measured by this
#: script on an NVIDIA H100 80GB HBM3 at 700 W: (4,10) x 8 MiB and the
#: piggyback emat (128,320) x 262,144
PREV_MS = {"flat encode": 0.1519, "piggyback emat": 4.6866}
#: (u, operand type) of K6a (u = 1) and K6b (u = 2, 4)
VARIANTS = ((1, "int8"), (1, "bf16"), (1, "tf32"), (2, "int8"), (2, "bf16"),
            (4, "int8"), (4, "bf16"))
#: the bit-plane variants' times per launch before the warpgroup-MMA
#: redesign (the wmma kernel), measured by this script on an NVIDIA H100
#: 80GB HBM3 at 700 W: (4,10) x 8 MiB, (128,320) x 262,144
PREV_BP_MS = {"gf_bitplane_int8": (0.8924, 10.0556),
              "gf_bitplane_bf16": (1.2012, 15.0650),
              "gf_bitplane_tf32": (2.2154, 31.1762),
              "gf_bitplane_u2_int8": (0.7886, 20.0024),
              "gf_bitplane_u2_bf16": (1.1034, 30.1401),
              "gf_bitplane_u4_int8": (1.3799, 39.8358),
              "gf_bitplane_u4_bf16": (2.0357, 60.0639)}
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")


def _k1() -> int:
    """K1's launches on the card in this process so far, from
    ops/device_stats (a call on the CPU is no launch)."""
    from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K1
    return DEVICE_STATS.launch_count(K1)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def _shas(paths) -> list:
    """The sha256 of each file, hashed at once (hashlib drops the GIL)."""
    with ThreadPoolExecutor(SHA_THREADS) as pool:
        return list(pool.map(_sha, paths))


PTXAS_KEEP = ("registers", "Compiling entry", "spill", "stack frame",
              "serialized")
PTXAS_SKIP = ("C7519",)  # "warpgroup.arrive is injected": one per wgmma


def build_kernels(modules, crc, plane, native) -> float:
    """One nvcc per kernel source, and the host compiler for the CRC32-C
    library, the native plane's library and its load generator and the
    native codec's library, all started together; prints each build's
    time and ptxas report (registers, spills, stack frames). Returns the
    wall time of the builds."""
    builds = [(mod.LIBRARY, ("nvcc",) + tuple(mod.NVCC_FLAGS),
               lambda mod=mod: mod.compile_kernel(ptxas_verbose=True))
              for mod in modules]
    builds.append((crc.LIBRARY, ("c++",) + tuple(crc.CXX_FLAGS),
                   crc.compile_library))
    builds.append((plane.LIBRARY, ("g++", "-shared") + plane.CXX_FLAGS,
                   plane.build_library))
    builds.append((plane.LOADGEN, ("g++",) + plane.CXX_FLAGS,
                   plane.compile_loadgen))
    builds.append((native.LIBRARY, ("g++",) + native.CXX_FLAGS,
                   native.compile_library))

    def build(entry):
        t0 = time.perf_counter()
        log = entry[2]()
        return log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        logs = list(pool.map(build, builds))
    wall = time.perf_counter() - t0
    for (library, flags, _), (log, secs) in zip(builds, logs):
        print(f"build: {' '.join(flags)} -> "
              f"{os.path.relpath(library, ROOT)} in {secs:.2f} s")
        for line in log.splitlines():
            if any(key in line for key in PTXAS_KEEP) and \
                    not any(key in line for key in PTXAS_SKIP):
                print("  ptxas:", line.strip())
    print(f"build: {len(builds)} libraries in {wall:.2f} s wall")
    return wall


def sass_counts(library) -> dict:
    """Instructions of each SASS_OPS kind in a built library
    (cuobjdump --dump-sass); raises unless there is warpgroup MMA and no
    legacy MMA."""
    import re
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(library)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
    print(f"sass {os.path.relpath(str(library), ROOT)}: {json.dumps(counts)}")
    if counts["HGMMA"] + counts["IGMMA"] == 0 or counts["HMMA"] + \
            counts["IMMA"] > 0:
        raise AssertionError(f"the bit-plane kernel is not warpgroup MMA "
                             f"only: {counts}")
    return counts


def geometries(np, gf256, NumpyCodec, seed):
    """(label, coeffs (r,k) uint8, widths) for the kernel-vs-plain phase."""
    out = []
    for k, m in ((10, 4), (6, 3), (20, 4)):
        for kind in ("vandermonde", "cauchy"):
            mat = gf256.build_matrix(k, k + m, kind)
            out.append((f"encode RS({k},{m}) {kind}", mat[k:], WIDTHS))
    for k, m, lost in ((10, 4, (0, 3, 11, 13)), (20, 4, (2, 9, 19, 21))):
        present = tuple(i not in lost for i in range(k + m))
        _, _, coeffs = NumpyCodec(k, m).decode_plan(present)
        out.append((f"decode RS({k},{m}) lost {lost}", coeffs, WIDTHS))
    present = tuple(i != 4 for i in range(14))
    _, row = NumpyCodec(10, 4).lost_row_coeffs(present, 4)
    out.append(("single row (1,10)", row, WIDTHS))
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (128, 640), dtype=np.uint8)
    out.append(("random (128,640)", big, (1, 129, 4407, (1 << 20) + 3)))
    return out


def check_kernel(torch, np, rs_hopper, gf_plan, geos, dev, seed,
                 misaligned=0):
    """K1 from each geometry's tile plan vs the plain version, byte for
    byte, on the card, over geos (label, coeffs, widths) and, if
    ``misaligned`` is a width, a base pointer off 16-byte alignment at the
    first geometry and that width. Returns max |err|."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    worst = 0
    cases = 0

    def held(label, n, const, c, d):
        got = rs_hopper.gf_matmul(const, d)
        want = rs_hopper.gf_matmul_plain(c, d)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain: {label} n={n}, "
                                 f"max |err| {err}")
        return err

    for label, coeffs, widths in geos:
        plan = gf_plan.make_plan(coeffs).to(dev)
        k = coeffs.shape[1]
        for n in widths:
            d = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                              generator=gen)
            worst = max(worst, held(label, n, plan, plan.coeffs, d))
            cases += 1
            del d
        torch.cuda.empty_cache()
    if misaligned:  # off 16-byte alignment: the byte path at full width
        plan = gf_plan.make_plan(geos[0][1]).to(dev)
        k, n = plan.k, misaligned
        flat = torch.randint(0, 256, (k * n + 1,), dtype=torch.uint8,
                             device=dev, generator=gen)
        worst = max(worst, held(f"misaligned base, {geos[0][0]}", n, plan,
                                plan.coeffs, flat[1:].view(k, n)))
        cases += 1
    print(f"kernel vs plain: {cases} cases over {len(geos)} geometries "
          f"byte-identical (tolerance: exact, GF(2^8) arithmetic; max |err| "
          f"{worst})")
    return worst


def piggyback_geometries(codec_mod):
    """(label, coeffs, widths) of the piggyback layout's largest products."""
    out = [("piggyback emat RS(10,4)", codec_mod.piggyback_plan(10, 4).emat,
            PB_WIDTHS)]
    for lost in ((0, 7, 11, 12), (1, 6, 10, 11)):
        _, _, dec = codec_mod.piggyback_decode_plan(
            10, 4, tuple(i not in lost for i in range(14)))
        out.append((f"piggyback decode RS(10,4) lost {lost}", dec, PB_WIDTHS))
    out.append(("piggyback emat RS(20,4)",
                codec_mod.piggyback_plan(20, 4).emat, PB_WIDTHS))
    return out


def check_bitplane(torch, np, rs_bitplane, rs_hopper, gf_plan, geos, dev,
                   seed, misaligned=False):
    """Every bit-plane variant against its plain version and against
    gf_matmul, and gf_matmul against its own plain version, byte for
    byte, on the card, over geos (label, coeffs, widths) and, if asked,
    one misaligned base pointer at the first geometry. Returns max |err|
    by variant name and "gf_matmul"."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    worst = {rs_bitplane.variant_name(u, dt): 0
             for u, dt in VARIANTS} | {"gf_matmul": 0}
    cases = 0

    def held(label, n, plan, lifts, d):
        coeffs_t = plan.coeffs
        k1 = rs_hopper.gf_matmul(plan, d)
        k1_plain = rs_hopper.gf_matmul_plain(coeffs_t, d)
        torch.cuda.synchronize()
        err = int((k1.int() - k1_plain.int()).abs().max().item())
        worst["gf_matmul"] = max(worst["gf_matmul"], err)
        if not torch.equal(k1, k1_plain):
            raise AssertionError(f"gf_matmul != plain: {label} n={n}, "
                                 f"max |err| {err}")
        del k1_plain
        r = coeffs_t.shape[0]
        plain = {u: rs_bitplane.bitplane_plain(lifts[u], d, r, u)
                 for u in lifts}
        for u, dt in VARIANTS:
            name = rs_bitplane.variant_name(u, dt)
            got = (rs_bitplane.bitplane_matmul(lifts[1], d, r, dt) if u == 1
                   else rs_bitplane.bitplane_matmul_batched(lifts[u], d, r,
                                                            u, dt))
            torch.cuda.synchronize()
            err = max(int((got.int() - plain[u].int()).abs().max().item()),
                      int((got.int() - k1.int()).abs().max().item()))
            worst[name] = max(worst[name], err)
            if not (torch.equal(got, plain[u]) and torch.equal(got, k1)):
                raise AssertionError(f"{name} != plain / gf_matmul: {label} "
                                     f"n={n}, max |err| {err}")

    for label, coeffs, widths in geos:
        bm = rs_bitplane.fuse_bitmat(coeffs)
        lifts = {u: torch.from_numpy(
            bm if u == 1 else rs_bitplane.block_diag_bitmat(bm, u)).to(dev)
            for u in (1, *rs_bitplane.BATCH_UNITS)}
        plan = gf_plan.make_plan(coeffs).to(dev)
        k = coeffs.shape[1]
        for n in widths:
            d = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                              generator=gen)
            held(label, n, plan, lifts, d)
            cases += 1
        del lifts
        torch.cuda.empty_cache()
    if misaligned:  # a base pointer off 16-byte alignment, 8 MiB wide
        coeffs = geos[0][1]
        bm = rs_bitplane.fuse_bitmat(coeffs)
        lifts = {u: torch.from_numpy(
            bm if u == 1 else rs_bitplane.block_diag_bitmat(bm, u)).to(dev)
            for u in (1, *rs_bitplane.BATCH_UNITS)}
        k = coeffs.shape[1]
        flat = torch.randint(0, 256, (k * MAIN_N + 1,), dtype=torch.uint8,
                             device=dev, generator=gen)
        held("misaligned base", MAIN_N, gf_plan.make_plan(coeffs).to(dev),
             lifts, flat[1:].view(k, MAIN_N))
        cases += 1
    print(f"bit-plane kernels vs plain and gf_matmul, gf_matmul vs plain: "
          f"{cases} cases x {len(VARIANTS)} variants byte-identical "
          f"(tolerance: exact, 0/1 operands and sums below 2^24); max |err| "
          f"{json.dumps(worst)}")
    return worst


def repair_targets(np, codec_mod, seed):
    """The repair legs' seeded lost shards and their plans: a trace
    repair of any of the 14 shards, a plane repair of a coupled data
    shard."""
    trace_lost = int(np.random.default_rng(seed + 17).integers(0, 14))
    coupled = codec_mod.piggyback_plan(10, 4).coupled
    plane_lost = int(np.random.default_rng(seed + 19).integers(0, coupled))
    return (codec_mod.repair_plan(10, 4, trace_lost),
            codec_mod.piggyback_repair_plan(10, 4, plane_lost))


def degraded_targets(np, codec_mod, NumpyCodec, seed):
    """The degraded legs' seeded lost data shard and the four K1 products
    of the degraded reads and the scrub: the flat lost row (1,10), the
    lost shard's alpha rows of the coupled decode plan (32,320), the
    flat syndrome rows (4,14) and the piggyback ones (128,448)."""
    lost = int(np.random.default_rng(seed + 37).integers(0, 10))
    present = tuple(i != lost for i in range(14))
    _, row = NumpyCodec(10, 4).lost_row_coeffs(present, lost)
    _, pmissing, coeffs = codec_mod.piggyback_decode_plan(10, 4, present)
    alpha = codec_mod.piggyback_plan(10, 4).alpha
    pos = pmissing.index(lost)
    pb_rows = np.ascontiguousarray(coeffs[pos * alpha:(pos + 1) * alpha])
    return lost, [
        ("degraded flat (1,10)", row, DEGRADED_WIDTHS),
        ("degraded piggyback (32,320)", pb_rows, PB_DEGRADED_WIDTHS),
        ("scrub flat (4,14)", NumpyCodec(10, 4).syndrome_plan(),
         SCRUB_WIDTHS),
        ("scrub piggyback (128,448)",
         codec_mod.piggyback_plan(10, 4).syndrome_rows(), PB_SCRUB_WIDTHS)]


def repair_geometries(plan, rplan):
    """(label, coeffs, widths) of the repair legs' two K1 products."""
    return [(f"trace combine lost {plan.lost}", plan.combine, TRACE_WIDTHS),
            (f"plane repair lost {rplan.lost}", rplan.matrix, PLANE_WIDTHS)]


def timed_shapes(np, gf256, NumpyCodec, codec_mod):
    """(label, coeffs, n) of the main path's K1 products: flat encode and
    the (0,1,2,3) decode plan at the 8 MiB slab, the piggyback emat and
    its (0,7,11,12) decode plan at its 262,144-column slab."""
    flat_dec = NumpyCodec(10, 4).decode_plan(
        tuple(i >= 4 for i in range(14)))[2]
    lost = (0, 7, 11, 12)
    pb_dec = codec_mod.piggyback_decode_plan(
        10, 4, tuple(i not in lost for i in range(14)))[2]
    return [("flat encode", gf256.build_matrix(10, 14)[10:], MAIN_N),
            ("flat decode (0, 1, 2, 3)", flat_dec, MAIN_N),
            ("piggyback emat", codec_mod.piggyback_plan(10, 4).emat, PB_N),
            (f"piggyback decode {lost}", pb_dec, PB_N)]


def time_kernel(torch, rs_hopper, gf_plan, kernel_exp, shapes, dev, seed):
    """CUDA-event times of K1 (its plan built beforehand, the build time
    printed on its own line and never inside a timed window) and of the
    plain version, beside the bytes bound, per (label, coeffs, n), with
    kernel_exp.per_launch_ms (the stream held until every launch of the
    window is enqueued). A shape whose input and output move less than
    twice the 50 MB L2 takes turns over enough input copies to reach it,
    so no launch finds its input in L2 from the launch before."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    cases = []
    for label, coeffs, n in shapes:
        r, k = coeffs.shape
        t0 = time.perf_counter()
        plan = gf_plan.make_plan(coeffs).to(dev)
        torch.cuda.synchronize()
        info = plan.summary() | {"build_ms": (time.perf_counter() - t0) * 1e3}
        print(f"plan {label} ({r},{k}): built and uploaded in "
              f"{info['build_ms']:.3f} ms, {plan.pairs} pairs per column, "
              f"{plan.table_bytes} table bytes, payload read "
              f"{info['payload_reads']:.2f} times over")
        copies = -(-2 * L2_BYTES // ((k + r) * n))
        d = [torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                           generator=gen) for _ in range(copies)]
        cases.append((label, plan, d, info))
    # Two passes over the shapes; the second is reported. The first shows
    # whether a window's time depends on what ran before it.
    first = {label: kernel_exp.per_launch_ms(
        _taking_turns(rs_hopper.gf_matmul, d), plan, None, reps=50)
        for label, plan, d, _ in cases}
    out = {}
    for label, plan, d, info in cases:
        (r, k), n = plan.coeffs.shape, d[0].shape[1]
        ms = kernel_exp.per_launch_ms(_taking_turns(rs_hopper.gf_matmul, d),
                                      plan, None, reps=50)
        plain_ms = kernel_exp.per_launch_ms(
            _taking_turns(lambda p, x: rs_hopper.gf_matmul_plain(p.coeffs, x),
                          d), plan, None, reps=3, warmup=1)
        nbytes = (k + r) * n
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        prev = PREV_MS.get(label)
        print(f"gf_matmul {label} ({r},{k}) x {n}: kernel {ms:.4f} ms "
              f"(first pass {first[label]:.4f} ms; {len(d)} input "
              f"copies in turn; {nbytes / ms / 1e6:.1f} GB/s of input + "
              f"output), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes: {nbytes} "
              f"at 3.35 TB/s), {ms / bound_ms:.2f}x the bound; previous "
              f"kernel {'not timed' if prev is None else f'{prev} ms'}")
        out[label] = {"shape": f"({r},{k})x{n}", "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "input_copies": len(d), "plan": info}
    del cases
    torch.cuda.empty_cache()
    return out


def _taking_turns(fn, inputs):
    """fn(const, x) with x the next of ``inputs`` in turn on each call."""
    turn = itertools.cycle(inputs)
    return lambda const, _: fn(const, next(turn))


def write_volume(np, SuperBlock, entry_to_bytes, base, nbytes, seed):
    """A seeded volume: superblock + one needle record in each 1 MiB
    slot of the .dat (a random payload and cookie, the slot's rest random
    bytes), and a .idx of those needles with overwrites and tombstones.
    Returns the .ecx bytes the sorted index must hold."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    rng = np.random.default_rng(seed)
    slot, size = 1 << 20, (1 << 20) - 64
    live = {}
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
        dat.write(SuperBlock().to_bytes())
        left = nbytes - 8
        for i in range(nbytes >> 20):
            nid = int(rng.integers(1, 1 << 40))
            # flags 1 byte + data size 4 bytes: the header's size is size
            rec = Needle(cookie=int(rng.integers(0, 1 << 32)), id=nid,
                         data=rng.bytes(size - 5)).to_bytes()
            fill = min(left, slot)
            dat.write(rec)
            dat.write(rng.bytes(fill - len(rec)))
            left -= fill
            entry = (8 + (i << 20), size)
            idx.write(entry_to_bytes(nid, *entry))
            live[nid] = entry
            if i % 7 == 3:  # delete an earlier needle
                victim = next(iter(live))
                idx.write(entry_to_bytes(victim, 0, 0xFFFFFFFF))
                live.pop(victim)
        if left:
            dat.write(rng.bytes(left))
    return b"".join(entry_to_bytes(nid, *live[nid]) for nid in sorted(live))


def main_path(torch, np, port, dev, base, nbytes, seed):
    """Encode + two rebuilds of one volume on the port's entry points.
    Returns the numbers to report."""
    ec, ops, storage = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    total = k + m
    t0 = time.perf_counter()
    want_ecx = write_volume(np, storage.SuperBlock, storage.entry_to_bytes,
                            base, nbytes, seed)
    print(f"volume: {nbytes} bytes written in "
          f"{time.perf_counter() - t0:.2f} s")

    ec.write_sorted_file_from_idx(base)
    with open(base + ".ecx", "rb") as f:
        if f.read() != want_ecx:
            raise AssertionError(".ecx differs from the sorted live index")

    slab = ec.encoder.DEFAULT_SLAB
    enc = {}
    t0 = time.perf_counter()
    ec.write_ec_files(base, codec=ops.get_codec(k, m, device=dev),
                      stats=enc)
    enc_s = time.perf_counter() - t0
    shard_size = os.path.getsize(base + ec.to_ext(0))
    n_slabs = math.ceil(shard_size / slab)
    if enc["dispatches"] != n_slabs or enc["bitmat_uploads"] != 1:
        raise AssertionError(f"encode counters {enc}, want {n_slabs} "
                             f"dispatches and 1 upload")
    shas = _shas([base + ec.to_ext(i) for i in range(total)])
    check_parity(np, ops, ec, base, k, m, shard_size, nbytes)
    enc_launches = _k1()
    print(f"encode: {nbytes / enc_s / 1e6:.1f} MB/s ({enc_s:.2f} s, shard "
          f"{shard_size} B, {enc['dispatches']} dispatches, phases "
          f"{enc['phases']})")

    rng = np.random.default_rng(seed + 7)
    random4 = tuple(sorted(rng.choice(total, 4, replace=False).tolist()))
    rebuilds = []
    for lost in ((0, 1, 2, 3), random4):
        for sid in lost:
            os.remove(base + ec.to_ext(sid))
        st = {}
        before = _k1()
        t0 = time.perf_counter()
        got = ec.rebuild_ec_files(base, codec=ops.get_codec(k, m, device=dev),
                                  stats=st)
        secs = time.perf_counter() - t0
        if sorted(got) != list(lost):
            raise AssertionError(f"rebuilt {got}, lost {lost}")
        got_shas = _shas([base + ec.to_ext(sid) for sid in range(total)])
        for sid in range(total):
            if got_shas[sid] != shas[sid]:
                raise AssertionError(f"shard {sid} differs after rebuilding "
                                     f"{lost}")
        if st["dispatches"] != n_slabs or st["bitmat_uploads"] != 1:
            raise AssertionError(f"rebuild counters {st}, want {n_slabs} "
                                 f"dispatches and 1 upload")
        rebuilds.append((lost, secs, st, _k1() - before))
        print(f"rebuild {lost}: {st['survivor_bytes'] / secs / 1e6:.1f} MB/s "
              f"of survivors ({secs:.2f} s, {st['dispatches']} dispatches, "
              f"phases {st['phases']}) — shards sha256-identical")
    return {"encode_s": enc_s, "encode_launches": enc_launches,
            "n_slabs": n_slabs, "shard_size": shard_size,
            "rebuilds": rebuilds, "shas": shas, "ecx_bytes": len(want_ecx)}


def native_leg(np, port, dev, work, base, res, k1_flat):
    """Step 5b: the host's native codec (ops/rs_native, csrc/seaweed_ec.cc
    built beside the nvcc builds) against K1 on the main path's .dat,
    each encode over a hard link in a directory of its own with the main
    path's 8 MiB slab, in the order native, K1, K1, native
    (ENCODE_ORDER), so that neither side alone gets the first read of the
    freshly written .dat; both codecs are built before the timing. Every
    encode's shards are sha256-identical to the main path's; a native
    encode launches no K1, a K1 encode one a slab. Then the native
    product alone on one (10 x 8 MiB) slab at one thread and at every
    core, beside K1's time at (4,10) x 8 MiB (``k1_flat``, timed in
    step 2 of this run), and ``auto`` resolved to the card's codec."""
    import torch
    from seaweedfs_tpu_torch.ops import rs_native
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    nbytes = os.path.getsize(base + ".dat")
    codec = ops.get_codec(k, m, "native")
    if type(codec) is not rs_native.NativeCodec or codec.threads != 0:
        raise AssertionError(f"native: get_codec gave {codec!r}")
    codecs = {"native": codec, "k1": ops.get_codec(k, m, device=dev)}
    runs, phases = [], {}
    for i, name in enumerate(ENCODE_ORDER):
        ndir = os.path.join(work, f"encode-{i}-{name}")
        os.makedirs(ndir)
        nbase = os.path.join(ndir, "1")
        _link(base + ".dat", nbase + ".dat")
        k1_before = _k1()
        st = {}
        t0 = time.perf_counter()
        ec.write_ec_files(nbase, codec=codecs[name], stats=st)
        secs = time.perf_counter() - t0
        launches = _k1() - k1_before
        shas = _shas([nbase + ec.to_ext(j) for j in range(k + m)])
        if shas != res["shas"]:
            bad = [j for j in range(k + m) if shas[j] != res["shas"][j]]
            raise AssertionError(f"{name} encode {i}: shards {bad} differ "
                                 f"from the main path's")
        want = (0, 0, "native") if name == "native" else \
            (res["n_slabs"], res["n_slabs"], "cuda")
        if (launches, st["dispatches"], st["backend"]) != want:
            raise AssertionError(f"{name} encode {i}: {launches} K1 "
                                 f"launches, stats {st}")
        shutil.rmtree(ndir)
        runs.append({"codec": name, "s": round(secs, 3),
                     "mb_s": round(nbytes / secs / 1e6, 1)})
        phases.setdefault(name, st.get("phases"))
    auto = ops.get_codec(k, m, "auto")
    if type(auto) is not TorchCodec or auto.device.type != "cuda":
        raise AssertionError(f"native: auto resolved to {auto!r}")
    # the product alone, one 8 MiB slab of each data shard
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (k, MAIN_N), dtype=np.uint8)
    coeffs = codec.matrix[k:]
    alone = {}
    for threads in (1, 0):
        one = rs_native.NativeCodec(k, m, threads=threads)
        want = one._matmul(coeffs, data)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = one._matmul(coeffs, data)
            times.append(time.perf_counter() - t0)
        if not np.array_equal(got, want):
            raise AssertionError("native: the product is not repeatable")
        best = min(times)
        alone["1 thread" if threads == 1 else "all threads"] = {
            "ms": round(best * 1e3, 3),
            "mb_s": round(data.nbytes / best / 1e6, 1)}
    k1_ms = k1_flat["ms"]
    walls = {name: [r["s"] for r in runs if r["codec"] == name]
             for name in codecs}
    mean = {name: sum(w) / len(w) for name, w in walls.items()}
    out = {"encode_runs": runs,
           "encode_s": round(mean["native"], 3),
           "encode_mb_s": round(nbytes / mean["native"] / 1e6, 1),
           "k1_encode_s": round(mean["k1"], 3),
           "k1_encode_mb_s": round(nbytes / mean["k1"] / 1e6, 1),
           "k1_speedup": round(mean["native"] / mean["k1"], 3),
           "k1_first_encode_s": round(res["encode_s"], 3),
           "k1_first_encode_mb_s": round(nbytes / res["encode_s"] / 1e6, 1),
           "host_cores": os.cpu_count(),
           "phases": phases,
           "product_alone": alone,
           "k1_product": {"shape": k1_flat["shape"], "ms": k1_ms,
                          "mb_s": round(data.nbytes / k1_ms / 1e3, 1)},
           "k1_product_speedup": round(
               alone["all threads"]["ms"] / k1_ms, 1)}
    print(card_line())
    order = ", ".join(f"{r['codec']} {r['mb_s']} MB/s ({r['s']:.3f} s)"
                      for r in runs)
    print(f"native codec on the host ({out['host_cores']} cores): encodes "
          f"of the {nbytes} B .dat in turn: {order}; native "
          f"{out['encode_mb_s']} MB/s, K1 {out['k1_encode_mb_s']} MB/s on "
          f"their mean walls: K1's encode {out['k1_speedup']}x as fast "
          f"(the main path's first K1 encode {out['k1_first_encode_mb_s']} "
          f"MB/s); every encode's 14 shards sha256-identical, 0 K1 "
          f"launches in a native one; the product alone (10 x {MAIN_N}): "
          f"1 thread {alone['1 thread']['mb_s']} MB/s, all threads "
          f"{alone['all threads']['mb_s']} MB/s, K1 {k1_ms:.4f} ms "
          f"({out['k1_product']['mb_s']} MB/s, "
          f"{out['k1_product_speedup']}x all threads'); auto -> "
          f"{type(auto).__name__}"
          f" on {auto.device}")
    print("native step: " + json.dumps(out))
    return out


def check_parity(np, ops, ec, base, k, m, shard_size, nbytes):
    """The numpy oracle re-encodes sampled columns of the written shards,
    and data shard 0 starts with the .dat's own bytes."""
    oracle = ops.NumpyCodec(k, m)
    for off in (0, shard_size // 2, shard_size - 4096):
        rows = []
        for sid in range(k + m):
            with open(base + ec.to_ext(sid), "rb") as f:
                f.seek(off)
                rows.append(np.frombuffer(f.read(4096), dtype=np.uint8))
        rows = np.stack(rows)
        if not np.array_equal(oracle.encode(rows[:k]), rows[k:]):
            raise AssertionError(f"parity at column {off} != numpy oracle")
    with open(base + ".dat", "rb") as a, open(base + ec.to_ext(0), "rb") as b:
        if a.read(1 << 20) != b.read(1 << 20):
            raise AssertionError("data shard 0 does not hold the .dat's "
                                 "first block")


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced(torch, label, fn, trace_path):
    """Runs fn under torch.profiler and prints the card's busy share of
    fn's wall: the union of the device's kernel, copy and memset
    intervals in the trace, over the host's wall time of fn. Returns
    the numbers, or None when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    os.remove(trace_path)
    if not events:
        print(f"traced {label}: not measured (the trace holds no device "
              f"events), wall {wall:.3f} s")
        return None
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_cat = {c: sum(e["dur"] for e in events if e["cat"] == c) / 1e3
              for c in DEVICE_CATS}
    kernel = [e["dur"] / 1e3 for e in events
              if e["cat"] == "kernel" and "gf_matmul" in e.get("name", "")]
    res = {"wall_s": wall, "busy_s": busy_us / 1e6,
           "busy_share": busy_us / 1e6 / wall, "ms_by_cat": by_cat,
           "kernel_launches": len(kernel),
           "kernel_ms_mean": sum(kernel) / len(kernel) if kernel else None}
    print(f"traced {label}: card busy {res['busy_s']:.4f} s of {wall:.3f} s "
          f"wall = {res['busy_share']:.2%} (idle {1 - res['busy_share']:.2%}"
          f"); device ms by kind {json.dumps(by_cat)}; gf_matmul "
          f"{len(kernel)} launches, mean {res['kernel_ms_mean']} ms in the "
          f"pipeline")
    return res


def trace_main_path(torch, port, dev, base, shas):
    """One more encode and one more rebuild (shards 0-3) of the volume,
    each traced; every shard must still be sha256-identical."""
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    trace_path = base + ".trace.json"
    out = {"encode": traced(torch, "encode", lambda: ec.write_ec_files(
        base, codec=ops.get_codec(k, m, device=dev)), trace_path)}
    for sid in range(4):
        os.remove(base + ec.to_ext(sid))
    out["rebuild"] = traced(torch, "rebuild (0, 1, 2, 3)",
                            lambda: ec.rebuild_ec_files(
                                base, codec=ops.get_codec(k, m, device=dev)),
                            trace_path)
    got = _shas([base + ec.to_ext(sid) for sid in range(k + m)])
    for sid in range(k + m):
        if got[sid] != shas[sid]:
            raise AssertionError(f"shard {sid} differs after the traced "
                                 f"encode and rebuild")
    return out


def piggyback_leg(np, port, dev, base, res, seed):
    """Piggyback encode of the same volume, in the Store's order (encode,
    then sidecars), then two coupled rebuilds. Returns the numbers."""
    ec, ops, storage = port
    from seaweedfs_tpu_torch.ec import layout as ec_layout
    from seaweedfs_tpu_torch.ops import codec as ops_codec
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    total, n_slabs = k + m, res["n_slabs"]
    with open(base + ".dat", "rb") as f:
        sb = storage.SuperBlock.from_bytes(f.read(storage.SUPER_BLOCK_SIZE))
    enc = {}
    start = _k1()
    t0 = time.perf_counter()
    ec.write_ec_files(base, codec=ops.get_codec(k, m, device=dev),
                      layout="piggyback", stats=enc)
    enc_s = time.perf_counter() - t0
    enc_launches = _k1() - start
    pplan = ops_codec.piggyback_plan(k, m)
    window = ops_codec.pb_window(ec.SMALL_BLOCK_SIZE, pplan.alpha)
    ec_layout.write_layout_sidecars(base, "piggyback", window, pplan.npairs,
                                    version=sb.version,
                                    offset_width=sb.offset_width)
    lay = ec_layout.volume_layout(base, k)
    if (lay.layout, lay.window, lay.pairs) != ("piggyback", 1 << 20, 5):
        raise AssertionError(f"volume_layout read back {lay}")
    with open(base + ".ecx", "rb") as f:
        ecx = f.read()
    if len(ecx) != res["ecx_bytes"] + 1 or ecx[-1] != 0x01:
        raise AssertionError(f".ecx is {len(ecx)} bytes ending in "
                             f"{ecx[-1]:#04x}, want {res['ecx_bytes'] + 1} "
                             f"ending in 0x01")
    shas = _shas([base + ec.to_ext(i) for i in range(total)])
    if shas[:k] != res["shas"][:k]:
        raise AssertionError("piggyback data shards differ from flat")
    if any(shas[i] == res["shas"][i] for i in range(k, total)):
        raise AssertionError("a piggyback parity shard equals flat")
    # numpy oracle on three sampled windows: split, emat product, merge
    shard_size = res["shard_size"]
    for off in (0, (shard_size // 2) // window * window, shard_size - window):
        rows = []
        for sid in range(total):
            with open(base + ec.to_ext(sid), "rb") as f:
                f.seek(off)
                rows.append(np.frombuffer(f.read(window), dtype=np.uint8))
        rows = np.stack(rows)
        sub = ops_codec.pb_split(rows[:k], pplan.alpha, window)
        want = ops_codec.pb_merge(ops.host_matmul(pplan.emat, sub),
                                  pplan.alpha, window)
        if not np.array_equal(want, rows[k:]):
            raise AssertionError(f"piggyback parity at {off} != numpy oracle")
    if enc["dispatches"] != n_slabs or enc["bitmat_uploads"] != 1 or \
            enc_launches != enc["dispatches"]:
        raise AssertionError(f"piggyback encode counters {enc}, "
                             f"{enc_launches} launches; want {n_slabs} "
                             f"dispatches = launches and 1 upload")
    print(f"piggyback encode: {os.path.getsize(base + '.dat') / enc_s / 1e6:.1f}"
          f" MB/s "
          f"({enc_s:.2f} s, {enc['dispatches']} dispatches = launches of "
          f"({pplan.emat.shape[0]},{pplan.emat.shape[1]}), phases "
          f"{enc['phases']}, pb split/merge s {enc['pb_host_s']}); "
          f"sidecars {lay}, .ecx {len(ecx)} B; data shards = flat, 4 parities "
          f"differ, parity = numpy oracle on 3 windows")

    rng = np.random.default_rng(seed + 11)
    random4 = tuple(sorted(rng.choice(total, 4, replace=False).tolist()))
    rebuilds = []
    for lost in ((0, 7, 11, 12), random4):
        for sid in lost:
            os.remove(base + ec.to_ext(sid))
        st = {}
        before = _k1()
        t0 = time.perf_counter()
        got = ec.rebuild_ec_files(base, codec=ops.get_codec(k, m, device=dev),
                                  layout=ec_layout.volume_layout(base, k),
                                  stats=st)
        secs = time.perf_counter() - t0
        launches = _k1() - before
        if sorted(got) != list(lost):
            raise AssertionError(f"rebuilt {got}, lost {lost}")
        got_shas = _shas([base + ec.to_ext(sid) for sid in range(total)])
        for sid in range(total):
            if got_shas[sid] != shas[sid]:
                raise AssertionError(f"piggyback shard {sid} differs after "
                                     f"rebuilding {lost}")
        if st["dispatches"] != n_slabs or st["bitmat_uploads"] != 1 or \
                launches != st["dispatches"] or st["layout"] != "piggyback":
            raise AssertionError(f"piggyback rebuild counters {st}, "
                                 f"{launches} launches")
        rebuilds.append((lost, secs, st))
        print(f"piggyback rebuild {lost}: {st['survivor_bytes'] / secs / 1e6:.1f}"
              f" MB/s of survivors ({secs:.2f} s, {st['dispatches']} "
              f"dispatches = launches, phases {st['phases']}, pb split/merge "
              f"s {st['pb_host_s']}) — shards sha256-identical")
    return {"encode_s": enc_s, "rebuilds": rebuilds, "shas": shas,
            "launches": _k1() - start}


def _check_leg(label, st, n_slabs, launches):
    """One K1 dispatch per stripe, each a launch, and one plan upload."""
    if st["dispatches"] != n_slabs or st["bitmat_uploads"] != 1 or \
            launches != st["dispatches"]:
        raise AssertionError(f"{label}: counters {st}, {launches} launches; "
                             f"want {n_slabs} dispatches = launches and 1 "
                             f"upload")


def _check_shas(ec, base, shas, label):
    got = _shas([base + ec.to_ext(sid) for sid in range(len(shas))])
    for sid, want in enumerate(shas):
        if got[sid] != want:
            raise AssertionError(f"shard {sid} differs after {label}")


def _leg_line(label, secs, st, moved, what):
    """A leg's wall, its MB/s (of ``moved`` bytes, named by ``what``) and
    its phases."""
    return (f"{label}: {secs:.2f} s, {moved / secs / 1e6:.1f} MB/s of "
            f"{what}, {st['dispatches']} dispatches = launches, phases "
            f"{st['phases']}")


def trace_repair_leg(np, port, dev, base, res, plan):
    """Trace repair of plan.lost from the packed symbol planes of every
    helper, through RepairGatherSource on the card's codec."""
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    lost, shard_size = plan.lost, res["shard_size"]
    os.remove(base + ec.to_ext(lost))
    gs = ec.GatherStats()
    source = ec.RepairGatherSource(
        [ec.LocalRepairReader(base + ec.to_ext(i), plan.masks[i], gs)
         for i in plan.helpers], shard_size, plan, slab=MAIN_N,
        window=GATHER_WINDOW, stats=gs)
    st = {}
    start = _k1()
    t0 = time.perf_counter()
    got = ec.rebuild_ec_file_repair(base, lost, source, plan,
                                    codec=ops.get_codec(k, m, device=dev),
                                    slab=MAIN_N, stats=st)
    secs = time.perf_counter() - t0
    if got != [lost]:
        raise AssertionError(f"trace repair rebuilt {got}, lost {lost}")
    _check_shas(ec, base, res["shas"], f"trace repair of {lost}")
    want_bytes = plan.total_bits * sum(
        (min(MAIN_N, shard_size - off) + 7) // 8
        for off in range(0, shard_size, MAIN_N))
    if st["repair_bytes"] != want_bytes or \
            st["repair_bytes_frac"] != round(plan.frac, 4):
        raise AssertionError(f"trace repair moved {st['repair_bytes']} B "
                             f"({st['repair_bytes_frac']}), want "
                             f"{want_bytes} ({plan.frac})")
    _check_leg("trace repair", st, res["n_slabs"],
               _k1() - start)
    print(_leg_line(f"trace repair shard {lost}", secs, st,
                    st["repair_bytes"], "symbol planes moved")
          + f"; {st['repair_bytes']} B = {st['repair_bytes_frac']} "
          f"of k x shard ({k * shard_size / secs / 1e6:.1f} MB/s of the "
          f"k x shard baseline), {plan.total_bits} bits from "
          f"{len(plan.helpers)} helpers, overlap {st['overlap_frac']}, "
          f"gather busy {st['gather_busy_s']} s — shard sha256-identical")
    return {"secs": secs, "stats": st}


def _seeded4(np, seed, total):
    rng = np.random.default_rng(seed)
    return tuple(sorted(rng.choice(total, 4, replace=False).tolist()))


def _gather_bound(peak, rows, label):
    bound = GATHER_WINDOW * rows * MAIN_N
    if not 0 < peak <= bound:
        raise AssertionError(f"{label}: peak_gather_buffer {peak} B outside "
                             f"(0, window x {rows} x 8 MiB = {bound}]")
    return bound


def streaming_leg(np, port, dev, base, res, seed):
    """Streaming rebuild of a seeded 4 from the first k survivors,
    pulled stripe by stripe through StripedGatherSource."""
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    total = k + m
    lost = _seeded4(np, seed + 23, total)
    for sid in lost:
        os.remove(base + ec.to_ext(sid))
    present = [i not in lost for i in range(total)]
    gs = ec.GatherStats()
    source = ec.StripedGatherSource(
        [ec.LocalShardReader(base + ec.to_ext(i), gs)
         for i in range(total) if present[i]][:k], res["shard_size"],
        slab=MAIN_N, window=GATHER_WINDOW, stats=gs)
    st = {}
    start = _k1()
    t0 = time.perf_counter()
    got = ec.rebuild_ec_files_streaming(
        base, present, list(lost), source,
        codec=ops.get_codec(k, m, device=dev), slab=MAIN_N, stats=st)
    secs = time.perf_counter() - t0
    if got != list(lost):
        raise AssertionError(f"streaming rebuilt {got}, lost {lost}")
    _check_shas(ec, base, res["shas"], f"streaming rebuild of {lost}")
    _check_leg("streaming rebuild", st, res["n_slabs"],
               _k1() - start)
    bound = _gather_bound(st["peak_gather_buffer"], k, "streaming rebuild")
    print(_leg_line(f"streaming rebuild {lost}", secs, st,
                    st["survivor_bytes"], "survivors")
          + f"; overlap_frac {st['overlap_frac']}, gather busy "
          f"{st['gather_busy_s']} s (the JAX definition: the readers' fetch "
          f"intervals only; stripe assembly runs on the consumer, so a "
          f"local gather overlaps little), compute {st['compute_busy_s']} s, "
          f"peak_gather_buffer {st['peak_gather_buffer']} B (bound {bound})"
          f" — shards sha256-identical")
    return {"lost": lost, "secs": secs, "stats": st}


def plane_repair_leg(np, port, dev, base, res, pb, rplan):
    """Plane repair of the coupled data shard rplan.lost from the
    half-plane of every helper, through PlaneGatherSource."""
    ec, ops, _ = port
    from seaweedfs_tpu_torch.ec import layout as ec_layout
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    lay = ec_layout.volume_layout(base, k)
    lost, shard_size = rplan.lost, res["shard_size"]
    os.remove(base + ec.to_ext(lost))
    gs = ec.GatherStats()
    source = ec.PlaneGatherSource(
        [ec.LocalPlaneReader(base + ec.to_ext(h), rplan.alpha, lay.window,
                             rplan.plane_bit, rplan.plane_side, gs)
         for h in rplan.helpers], shard_size, rplan, lay.window, slab=MAIN_N,
        gather_window=GATHER_WINDOW, stats=gs)
    st = {}
    start = _k1()
    t0 = time.perf_counter()
    got = ec.rebuild_ec_file_piggyback(base, lost, source, rplan, lay.window,
                                       codec=ops.get_codec(k, m, device=dev),
                                       slab=source.slab, stats=st)
    secs = time.perf_counter() - t0
    if got != [lost]:
        raise AssertionError(f"plane repair rebuilt {got}, lost {lost}")
    _check_shas(ec, base, pb["shas"], f"plane repair of {lost}")
    if st["repair_bytes_frac"] != 0.55 or \
            st["repair_bytes"] != len(rplan.helpers) * shard_size // 2:
        raise AssertionError(f"plane repair moved {st['repair_bytes']} B "
                             f"({st['repair_bytes_frac']}), want 0.55 of "
                             f"k x shard")
    _check_leg("plane repair", st, res["n_slabs"],
               _k1() - start)
    print(_leg_line(f"plane repair shard {lost}", secs, st,
                    st["repair_bytes"], "half-planes moved")
          + f"; {st['repair_bytes']} B = {st['repair_bytes_frac']} of "
          f"k x shard ({k * shard_size / secs / 1e6:.1f} MB/s of the "
          f"k x shard baseline), {len(rplan.helpers)} helpers x half a "
          f"shard, overlap {st['overlap_frac']} — shard sha256-identical")
    return {"secs": secs, "stats": st}


def streaming_piggyback_leg(np, port, dev, base, res, pb, seed):
    """Streaming piggyback rebuild of a seeded 4, the readers in the
    coupled decode plan's src order."""
    ec, ops, _ = port
    from seaweedfs_tpu_torch.ec import layout as ec_layout
    from seaweedfs_tpu_torch.ops import codec as ops_codec
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    total = k + m
    lay = ec_layout.volume_layout(base, k)
    lost = _seeded4(np, seed + 29, total)
    for sid in lost:
        os.remove(base + ec.to_ext(sid))
    present = [i not in lost for i in range(total)]
    src, _, _ = ops_codec.piggyback_decode_plan(k, m, tuple(present),
                                                pairs=lay.pairs)
    gs = ec.GatherStats()
    source = ec.StripedGatherSource(
        [ec.LocalShardReader(base + ec.to_ext(i), gs) for i in src],
        res["shard_size"], slab=MAIN_N, window=GATHER_WINDOW, stats=gs)
    st = {}
    start = _k1()
    t0 = time.perf_counter()
    got = ec.rebuild_ec_files_streaming_piggyback(
        base, present, list(lost), source, lay,
        codec=ops.get_codec(k, m, device=dev), stats=st)
    secs = time.perf_counter() - t0
    if got != list(lost):
        raise AssertionError(f"streaming piggyback rebuilt {got}, lost {lost}")
    _check_shas(ec, base, pb["shas"], f"streaming piggyback rebuild of {lost}")
    _check_leg("streaming piggyback rebuild", st, res["n_slabs"],
               _k1() - start)
    _gather_bound(st["peak_gather_buffer"], len(src),
                  "streaming piggyback rebuild")
    print(_leg_line(f"streaming piggyback rebuild {lost}", secs, st,
                    st["survivor_bytes"], "survivors")
          + f"; pb split/merge s {st['pb_host_s']}, "
          f"peak_gather_buffer {st['peak_gather_buffer']} B — shards "
          f"sha256-identical")
    return {"lost": lost, "secs": secs, "stats": st}


class _Store:
    """The one mounted EC volume, as a volume server's store gives it to
    the degraded-read and scrub engines."""

    def __init__(self, ev):
        self.ev = ev
        self.locations = [type("Location", (), {"ec_volumes": {1: ev}})]

    def find_ec_volume(self, vid):
        return self.ev if vid == 1 else None


def _mount(ec, base, skip=()):
    ev = ec.EcVolume(os.path.dirname(base), "", 1)
    for sid in range(ec.TOTAL_SHARDS):
        if sid not in skip:
            ev.add_shard(sid)
    return ev


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def degraded_leg(np, port, dev, base, res, lost, seed, label,
                 gets=DEGRADED_GETS):
    """``gets`` needle GETs through a lost data shard on the mounted
    volume, every survivor local; the shard is moved aside for the leg
    and back after it (_serve_degraded)."""
    ec, ops, _ = port
    path = base + ec.to_ext(lost)
    ev = _mount(ec, base, skip=(lost,))
    os.rename(path, path + ".lost")
    codec = ops.get_codec(ec.DATA_SHARDS, ec.PARITY_SHARDS, device=dev)
    eng = ec.DegradedReadEngine(_Store(ev), lambda vid: {}, lambda: codec)
    try:
        return _serve_degraded(np, port, base, res, ev, eng, lost,
                               path + ".lost", seed, label, gets)
    finally:
        os.rename(path + ".lost", path)
        ev.close()
        eng.close()


def _serve_degraded(np, port, base, res, ev, eng, lost, truth, seed, label,
                    gets=DEGRADED_GETS):
    """``gets`` needle GETs whose intervals touch the lost shard, from
    DEGRADED_THREADS threads (EcVolume.read_needle_blob with the engine's
    read as its reconstruct fetch; a needle here never spans two small
    blocks, so it touches no other shard), each blob held against the
    .dat, then one DEGRADED_WIDE read of the lost shard with the slab
    cache emptied, held against ``truth`` (the shard's bytes)."""
    ec, ops, storage = port
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    start = _k1()
    rec = storage.entry_size()
    with open(base + ".ecx", "rb") as f:
        ecx = f.read()
    nids = [int.from_bytes(ecx[i:i + 8], "big")
            for i in range(0, len(ecx) // rec * rec, rec)]
    touching = [nid for nid in nids
                if any(iv.to_shard_id_and_offset(
                    ec.LARGE_BLOCK_SIZE, ec.SMALL_BLOCK_SIZE)[0] == lost
                    for iv in ev.locate_needle(nid)[2])]
    rng = np.random.default_rng(seed)
    picks = [touching[i] for i in rng.permutation(len(touching))[:gets]]
    if len(picks) < min(32, gets):
        raise AssertionError(f"{label}: only {len(picks)} needles touch "
                             f"shard {lost}")

    def get(nid):
        t0 = time.perf_counter()
        blob = ev.read_needle_blob(nid, reconstruct_fetch=eng.read)
        secs = time.perf_counter() - t0
        off, size, _ = ev.locate_needle(nid)
        with open(base + ".dat", "rb") as f:
            f.seek(off)
            want = f.read(get_actual_size(size, ev.version))
        if blob != want:
            raise AssertionError(f"{label}: needle {nid:#x} differs from "
                                 f"the .dat at {off}")
        return secs, len(blob)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(DEGRADED_THREADS) as pool:
        got = list(pool.map(get, picks))
    gets_s = time.perf_counter() - t0
    lat = [secs * 1e3 for secs, _ in got]
    first = eng.snapshot()
    eng.invalidate(1)
    off = int(rng.integers(0, (res["shard_size"] - DEGRADED_WIDE)
                           // (1 << 20))) << 20
    t0 = time.perf_counter()
    wide = eng.read(1, lost, off, DEGRADED_WIDE)
    wide_s = time.perf_counter() - t0
    with open(truth, "rb") as f:
        f.seek(off)
        if wide != f.read(DEGRADED_WIDE):
            raise AssertionError(f"{label}: wide read at {off} differs "
                                 f"from shard {lost}")
    snap = eng.snapshot()
    launches = _k1() - start
    if launches != snap["device_dispatches"] or launches < 1 or \
            snap["errors"]:
        raise AssertionError(f"{label}: {launches} launches for "
                             f"{snap['device_dispatches']} device "
                             f"dispatches, {snap['errors']} errors")
    keys = ("batches", "host_dispatches", "device_dispatches",
            "cache_hit_ratio", "survivor_fetches", "survivor_bytes",
            "remote_bytes", "retries")
    print(f"{label}: lost shard {lost}, {len(picks)} needle GETs from "
          f"{DEGRADED_THREADS} threads in {gets_s:.3f} s, p50 "
          f"{_pct(lat, 0.5):.3f} ms, p99 {_pct(lat, 0.99):.3f} ms, "
          f"{sum(n for _, n in got)} B, every blob = the .dat's bytes; "
          f"{json.dumps({key: first[key] for key in keys})}; wide read "
          f"{DEGRADED_WIDE} B at {off} in {wide_s:.3f} s "
          f"({DEGRADED_WIDE / wide_s / 1e6:.1f} MB/s) = the shard's bytes; "
          f"after both {json.dumps({key: snap[key] for key in keys})}, "
          f"{launches} launches = device dispatches, batch phases "
          f"{json.dumps(snap['phases'])}")
    return {"gets": len(picks), "p50_ms": _pct(lat, 0.5),
            "p99_ms": _pct(lat, 0.99), "wide_s": wide_s,
            "wide_mb_s": DEGRADED_WIDE / wide_s / 1e6, "stats": snap}


def scrub_leg(np, port, dev, base, res, shas, seed, label):
    """A clean scrub pass of the mounted volume, every shard local, then
    a pass with one seeded byte of a seeded shard flipped
    (_scrub_drill)."""
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    ev = _mount(ec, base)
    codec = ops.get_codec(k, m, device=dev)
    eng = ec.ScrubEngine(_Store(ev), lambda vid: {}, lambda: codec,
                         lambda: "smoke", rate_mbps=0)
    rng = np.random.default_rng(seed)
    sid = int(rng.integers(0, k + m))
    off = int(rng.integers(0, res["shard_size"]))
    try:
        return _scrub_drill(port, base, res, shas, eng, sid, off,
                            [base + ec.to_ext(sid)], label)
    finally:
        ev.close()


def tuner_leg(np, port, seed):
    """(a) The small-dispatch tuner on the card: a fresh
    stats/metrics.SmallDispatchTuner and TorchCodec(10, 4, device=
    TUNER_DEVICE); reconstructs of TUNER_LOST at every
    TUNER_DEVICE_WIDTHS (K1) and then every TUNER_HOST_WIDTHS (the host),
    TUNER_ROUNDS each, with ops/codec.SMALL_DISPATCH_AUTO on for the
    leg only: each reconstruct span feeds the tuner its width and
    seconds, and the fitted crossover goes live. Every output held
    against the NumpyCodec encode of the same seeded data. Then
    dispatch_threshold must be the tuner's suggestion, a reconstruct one
    byte below it launch no K1 and one at it exactly one (the auto
    constant off for these two, so their own samples move nothing). The
    tuner, the constant and the override are restored in a finally.
    Returns the fit."""
    ec, ops, _ = port
    from seaweedfs_tpu_torch.ops import codec as ops_codec
    from seaweedfs_tpu_torch.ops.rs_torch import TorchCodec
    from seaweedfs_tpu_torch.stats import metrics
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    codec = TorchCodec(k, m, device=TUNER_DEVICE)
    rng = np.random.default_rng(seed)
    # wide enough for the launch checks at any crossover the tuner gives
    n = max(max(TUNER_DEVICE_WIDTHS), metrics.SmallDispatchTuner.CLAMP[1])
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    full = np.concatenate([data, ops_codec.NumpyCodec(k, m).encode(data)])

    def reconstruct(w):
        shards = [None if i in TUNER_LOST else full[i, :w]
                  for i in range(k + m)]
        out = codec.reconstruct(shards)
        for i in TUNER_LOST:
            if not np.array_equal(out[i], full[i, :w]):
                raise AssertionError(f"tuner: reconstruct of shard {i} at "
                                     f"width {w} differs from NumpyCodec")

    # warm: the plan built and uploaded, the card's first launch, before
    # the tuner learns
    reconstruct(min(TUNER_DEVICE_WIDTHS))
    reconstruct(min(TUNER_HOST_WIDTHS))
    saved = metrics.SMALL_DISPATCH_TUNER
    tuner = metrics.SMALL_DISPATCH_TUNER = metrics.SmallDispatchTuner()
    ops_codec.SMALL_DISPATCH_AUTO = True
    try:
        t0 = time.perf_counter()
        # K1 widths first: no suggestion (none before four host samples)
        # moves the crossover while they run, and the host widths lie
        # below any crossover the tuner can install
        for widths, want in ((TUNER_DEVICE_WIDTHS, 1),
                             (TUNER_HOST_WIDTHS, 0)):
            for _ in range(TUNER_ROUNDS):
                for w in widths:
                    before = _k1()
                    reconstruct(w)
                    if _k1() - before != want:
                        raise AssertionError(
                            f"tuner: width {w}: {_k1() - before} K1 "
                            f"launches, not {want}")
        sample_s = time.perf_counter() - t0
        host, device = list(tuner._host), list(tuner._device)
        suggestion = tuner.suggest()
        thr = ops_codec.dispatch_threshold(codec)
        if suggestion is None or thr != suggestion or \
                ops_codec.small_dispatch_override() != suggestion:
            raise AssertionError(f"tuner: suggestion {suggestion}, live "
                                 f"crossover {thr}")
        ops_codec.SMALL_DISPATCH_AUTO = False
        launches = []
        for w in (thr - 1, thr):
            before = _k1()
            reconstruct(w)
            launches.append(_k1() - before)
        if launches != [0, 1]:
            raise AssertionError(f"tuner: K1 launches at {thr - 1} and "
                                 f"{thr}: {launches}")
        # the card wins at every sampled width: the tuner's floor,
        # whatever the sign of the fitted intercept
        if suggestion != metrics.SmallDispatchTuner.CLAMP[0] and \
                TUNER_DEVICE != "cpu":
            raise AssertionError(
                f"tuner: installed {suggestion} B, not the floor "
                f"{metrics.SmallDispatchTuner.CLAMP[0]}")
    finally:
        metrics.SMALL_DISPATCH_TUNER = saved
        ops_codec.SMALL_DISPATCH_AUTO = False
        ops_codec.set_small_dispatch_override(None)
    # the tuner's own fit, in its units: bytes are widths
    host_mb_s = sum(b for b, _ in host) / sum(t for _, t in host) / 1e6
    mx = sum(b for b, _ in device) / len(device)
    my = sum(t for _, t in device) / len(device)
    slope = sum((x - mx) * (y - my) for x, y in device) / \
        sum((x - mx) ** 2 for x, _ in device)
    intercept = my - slope * mx
    by_width = {}
    for b_, t in host + device:
        by_width.setdefault(int(b_), []).append(round(t * 1e3, 4))
    fit = {"suggestion": suggestion, "host_samples": len(host),
           "device_samples": len(device),
           "host_mb_s": round(host_mb_s, 3),
           "device_intercept_ms": round(intercept * 1e3, 6),
           "device_slope_ns_per_byte": round(slope * 1e9, 6),
           "device_mb_s": round(1 / slope / 1e6, 3) if slope > 0 else None,
           "sample_s": round(sample_s, 3),
           "launches_below_at": launches,
           "clamped": suggestion in metrics.SmallDispatchTuner.CLAMP,
           "ms_by_width": by_width}
    print(f"tuner: K1 crossover {suggestion} B of width (RS(10,4), 4 lost "
          f"shards: a reconstruct reads {k} x width), fitted from "
          f"{len(host)} host and {len(device)} device reconstruct spans "
          f"in {sample_s:.2f} s: host {fit['host_mb_s']} MB/s of width, "
          f"device {fit['device_intercept_ms']} ms + "
          f"{fit['device_slope_ns_per_byte']} ns a byte of width "
          f"({fit['device_mb_s']} MB/s); dispatch_threshold = the "
          f"suggestion; K1 launches at {thr - 1} and {thr} B: {launches}"
          + ("; clamped to the tuner's range"
             if fit["clamped"] else ""))
    print(f"tuner: {json.dumps(fit)}")
    return fit


def _scrub_drill(port, base, res, shas, eng, sid, off, paths, label):
    """A clean pass, then a pass with byte ``off`` of shard ``sid``
    flipped in each of ``paths`` (its copies), which must be found in its
    slab and attributed to its shard; the byte is put back and the
    shard's sha256 checked."""
    ec, ops, _ = port
    start = _k1()
    passes = []
    for flip in (False, True):
        if flip:
            for path in paths:
                _flip_byte(path, off)
        try:
            passes.append(eng.scrub_volume(1, force=True))
        finally:
            if flip:
                for path in paths:
                    _flip_byte(path, off)
    clean, found = passes
    n_slabs = -(-res["shard_size"] // SCRUB_N)
    if not clean["clean"] or clean["slabs"] != n_slabs or \
            clean["path"] != "device":
        raise AssertionError(f"{label}: clean pass {clean}")
    if found["corrupt_slabs"] != [off // SCRUB_N] or \
            found["corrupt_shards"] != [sid] or found["corrupt_columns"] != 1:
        raise AssertionError(f"{label}: byte {off} of shard {sid} flipped, "
                             f"pass found {found}")
    if _sha(base + ec.to_ext(sid)) != shas[sid]:
        raise AssertionError(f"{label}: shard {sid} differs after the byte "
                             f"was put back")
    snap = eng.snapshot()
    launches = _k1() - start
    if launches != snap["device_dispatches"] or launches != 2 * n_slabs:
        raise AssertionError(f"{label}: {launches} launches for "
                             f"{snap['device_dispatches']} device dispatches")
    print(f"{label}: clean pass {clean['bytes'] / clean['seconds'] / 1e6:.1f}"
          f" MB/s verified ({clean['bytes']} B in {clean['seconds']:.3f} s, "
          f"{clean['slabs']} slabs, phases {json.dumps(clean['phases'])}); "
          f"byte {off} of shard {sid} flipped: slab {found['corrupt_slabs']},"
          f" shards {found['corrupt_shards']}, "
          f"{found['corrupt_columns']} column, in {found['seconds']:.3f} s; "
          f"put back, sha256-identical; {launches} launches = device "
          f"dispatches; remote bytes {snap['remote_bytes']}")
    return {"clean": clean, "found": found, "sid": sid, "off": off,
            "mb_s": clean["bytes"] / clean["seconds"] / 1e6, "stats": snap}


def _flip_byte(path, off):
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)[0]
        f.seek(off)
        f.write(bytes([b ^ 0x01]))


def decode_leg(np, port, base, res, seed):
    """ec.decode from the data shards: the .dat's first dat_size bytes
    and an .idx of the .ecx records plus the .ecj's tombstones."""
    ec, _, storage = port
    dat = base + ".dat"
    t0 = time.perf_counter()
    size = ec.find_dat_file_size(base)
    with open(dat, "rb") as f:
        want = hashlib.sha256()
        left = size
        while left:
            chunk = f.read(min(left, 64 << 20))
            want.update(chunk)
            left -= len(chunk)
    os.remove(dat)
    t1 = time.perf_counter()
    ec.write_dat_file(base, size)
    dat_s = time.perf_counter() - t1
    if os.path.getsize(dat) != size or _sha(dat) != want.hexdigest():
        raise AssertionError(f"decoded .dat ({os.path.getsize(dat)} B) is "
                             f"not the original's first {size} bytes")
    rng = np.random.default_rng(seed + 31)
    rec = storage.entry_size()
    with open(base + ".ecx", "rb") as f:
        ecx = f.read()
    aligned = ecx[:len(ecx) // rec * rec]
    picks = rng.choice(len(aligned) // rec, 2, replace=False)
    nids = [aligned[i * rec:i * rec + 8] for i in sorted(picks.tolist())]
    with open(base + ".ecj", "wb") as f:
        f.write(b"".join(nids))
    t1 = time.perf_counter()
    ec.write_idx_file_from_ec_index(base)
    idx_s = time.perf_counter() - t1
    with open(base + ".idx", "rb") as f:
        idx = f.read()
    tomb = b"".join(storage.entry_to_bytes(int.from_bytes(n, "big"), 0,
                                           0xFFFFFFFF) for n in nids)
    if idx != aligned + tomb:
        raise AssertionError(f".idx ({len(idx)} B) is not the .ecx records "
                             f"({len(aligned)} B) plus 2 tombstones")
    secs = time.perf_counter() - t0
    print(f"decode: {secs:.2f} s, .dat {size} B in {dat_s:.2f} s "
          f"({size / dat_s / 1e6:.1f} MB/s) = the original's first {size} "
          f"bytes (sha256), .idx {len(idx)} B in {idx_s:.3f} s = .ecx "
          f"records ({len(ecx) - len(aligned)} tag byte dropped) + 2 "
          f"tombstones")
    return {"secs": secs, "dat_s": dat_s, "dat_size": size}


class ServerProcesses:
    """Port volume servers as processes (``python3 -m
    seaweedfs_tpu_torch.server.volume_server``) on 127.0.0.1, one per
    name, each over its own directory. A server that does not print its
    port within HOLDER_START_S, or exits, fails the run."""

    what = "volume server"

    def __init__(self):
        self.procs, self.urls, self.dirs = {}, {}, {}

    def spawn(self, name, d, *args):
        """Start ``name`` over directory ``d`` without waiting for it,
        its background scrub off (a pass at a random moment would launch
        K1 outside the leg's count)."""
        self.dirs[name] = d
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m",
             "seaweedfs_tpu_torch.server.volume_server", "--dir", d,
             "--scrub-idle-s", "0", "-fastPort", "-1", *args],
            cwd=ROOT, stdout=subprocess.PIPE,
            stderr=open(d + ".log", "wb"), text=True)

    def wait_listening(self, names):
        """Each of ``names`` has printed its address."""
        deadline = time.monotonic() + HOLDER_START_S
        for name in names:
            proc, line = self.procs[name], ""
            while not line and time.monotonic() < deadline:
                ready, _, _ = select.select([proc.stdout], [], [], 0.5)
                if ready:
                    line = proc.stdout.readline()
                    if not line:
                        break
            if not line.startswith("listening "):
                with open(self.dirs[name] + ".log", "rb") as f:
                    err = f.read()[-2000:].decode("utf-8", "replace")
                raise AssertionError(f"{self.what} {name} did not start "
                                     f"(exit {proc.poll()}): {err}")
            self.urls[name] = line.split()[1]
        return self

    def kill(self, name):
        proc = self.procs.pop(name)
        proc.kill()
        proc.wait()
        proc.stdout.close()

    def stop_processes(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        self.procs = {}


class Holders(ServerProcesses):
    """Three holder processes (``python3 -m
    seaweedfs_tpu_torch.server.volume_server``) on 127.0.0.1, each over a
    directory of hard links (copies where a link fails) to the volume's
    .ecx, .vif and the shards ``holds`` gives it (NET_HOLDS by default),
    or over an empty directory with ``empty``. Separate processes, so
    the rebuilder's GIL is not theirs. A holder that does not print its
    port within HOLDER_START_S, or exits, fails the run."""

    what = "holder"

    def __init__(self, base, work, label, total, holds=None, empty=False):
        super().__init__()
        self.base = base
        self.work = work
        self.label = label
        self.total = total
        self.holds = NET_HOLDS if holds is None else holds
        self.empty = empty

    def start(self):
        return self.spawn_all().wait_all()

    def spawn_all(self):
        """Link each holder's files and start its process, not waiting
        for it: a leg that comes later can start its holders while an
        earlier leg's start up or run."""
        for name, sids in self.holds.items():
            d = os.path.join(self.work, f"holder-{self.label}-{name}")
            os.makedirs(d)
            exts = [] if self.empty else \
                [".ecx", ".vif"] + [f".ec{sid:02d}" for sid in sids]
            for ext in exts:
                src = self.base + ext
                if not os.path.exists(src):
                    continue
                _link(src, os.path.join(d, os.path.basename(src)))
            self.spawn(name, d)
        return self

    def wait_all(self):
        self.wait_listening(list(self.holds))
        print(f"holders {self.label}: " + ", ".join(
            f"{name} {self.urls[name]} shards {list(self.holds[name])}"
            + (" (empty)" if self.empty else "")
            for name in self.holds))
        return self

    def stop(self):
        self.stop_processes()
        for d in self.dirs.values():
            shutil.rmtree(d, ignore_errors=True)

    def sources(self, lost=()):
        """{sid: [holder urls]} of every shard not in ``lost``."""
        return {sid: [self.urls[name] for name, sids in self.holds.items()
                      if sid in sids]
                for sid in range(self.total) if sid not in lost}

    def names(self, by_url):
        return {name: by_url.get(url, 0) for name, url in self.urls.items()}

    def copies(self, sid):
        """Every file of shard ``sid`` under the holders, the volume's own
        included, one path per inode."""
        seen, out = set(), []
        for path in [self.base + f".ec{sid:02d}"] + [
                os.path.join(d, os.path.basename(self.base) + f".ec{sid:02d}")
                for d in self.dirs.values()]:
            if os.path.exists(path):
                ino = os.stat(path).st_ino
                if ino not in seen:
                    seen.add(ino)
                    out.append(path)
        return out


def _link(src, dst):
    """A hard link to ``src`` at ``dst``, or a copy where linking fails."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _rotation_fetches(sources, sids, stripes):
    """{holder url: fetches} that rotation by stripe gives when ``sids``
    are each read ``stripes`` times from their holders: stripe i of a
    shard leads with holder i % len(holders)."""
    out = {}
    for sid in sids:
        urls = sources[sid]
        for i in range(stripes):
            out[urls[i % len(urls)]] = out.get(urls[i % len(urls)], 0) + 1
    return out


def _net_store(port, work):
    """The rebuilder: a Store over an empty directory, its codec the
    default (TorchCodec on the card)."""
    from seaweedfs_tpu_torch.storage.store import Store
    d = os.path.join(work, "rebuilder")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return Store([d]), os.path.join(d, "1")


def _net_leg(port, holders, work, lost, shas, label, read_sids, want_mode,
             want_frac=None):
    """One network rebuild of ``lost`` through the Store with ``-repair
    auto`` and sources for every survivor: every rebuilt shard
    sha256-identical, the route taken, the remote bytes, and the fetches
    per holder exactly what rotation gives (so both holders of shards 0
    and 1 served them)."""
    ec, ops, _ = port
    store, rbase = _net_store(port, work)
    sources = holders.sources(lost)
    st = {}
    start = _k1()
    t0 = time.perf_counter()
    got = store.rebuild_ec_shards_streaming(1, sources=sources, stats=st,
                                            repair="auto")
    secs = time.perf_counter() - t0
    launches = _k1() - start
    if got != list(lost):
        raise AssertionError(f"{label}: rebuilt {got}, lost {lost}")
    for sid in lost:
        if _sha(rbase + ec.to_ext(sid)) != shas[sid]:
            raise AssertionError(f"{label}: shard {sid} differs")
    if st["repair_mode"] != want_mode or (
            want_frac is not None and st["repair_bytes_frac"] != want_frac):
        raise AssertionError(f"{label}: route {st['repair_mode']} "
                             f"({st.get('repair_bytes_frac')}), want "
                             f"{want_mode} ({want_frac})")
    want = _rotation_fetches(sources, read_sids, st["gather_stripes"])
    if st["holder_fetches"] != want or st["gather_retries"] or \
            st["holder_errors"] or st["gather_remote_shards"] != \
            len(read_sids) or launches != st["dispatches"]:
        raise AssertionError(f"{label}: holder fetches "
                             f"{st['holder_fetches']} (want {want}), "
                             f"retries {st['gather_retries']}, errors "
                             f"{st['holder_errors']}, {launches} launches "
                             f"for {st['dispatches']} dispatches")
    moved = st["gather_remote_bytes"]
    shard_size = os.path.getsize(rbase + ec.to_ext(lost[0]))
    print(f"{label}: {secs:.2f} s, {moved / secs / 1e6:.1f} MB/s of "
          f"{moved} B over HTTP ({ec.DATA_SHARDS * shard_size / secs / 1e6:.1f}"
          f" MB/s of the k x shard baseline), route {st['repair_mode']}"
          + (f" (fallback: {st['repair_fallback']})"
             if "repair_fallback" in st else "")
          + f", phases {st['phases']}, gather busy {st['gather_busy_s']} s, "
          f"overlap {st['overlap_frac']}, {st['gather_fetches']} fetches, "
          f"{st['gather_retries']} retries, fetches by holder "
          f"{json.dumps(holders.names(st['holder_fetches']))}, "
          f"{launches} launches = dispatches — shards sha256-identical")
    return {"secs": secs, "stats": st, "launches": launches}


def net_trace_leg(np, port, holders, work, res, plan):
    """Trace repair of plan.lost from the holders: exactly the plan's
    symbol bytes cross the wire, 0.6875 of k x shard for shard 10."""
    ec, _, _ = port
    out = _net_leg(port, holders, work, (plan.lost,), res["shas"],
                   f"net trace repair shard {plan.lost}", plan.helpers,
                   "trace", round(plan.frac, 4))
    size = res["shard_size"]
    symbols = plan.total_bits * sum((min(MAIN_N, size - off) + 7) // 8
                                    for off in range(0, size, MAIN_N))
    if out["stats"]["gather_remote_bytes"] != symbols or \
            out["stats"]["repair_bytes_frac"] != 0.6875:
        raise AssertionError(f"net trace repair moved "
                             f"{out['stats']['gather_remote_bytes']} B, "
                             f"want the plan's {symbols} (0.6875)")
    return out


def net_full_leg(np, port, holders, work, res, seed):
    """The seeded 4 of the streaming leg lost: -repair auto falls back to
    the full streaming decode, k x shard over the wire."""
    ec, _, _ = port
    lost = _seeded4(np, seed + 23, ec.TOTAL_SHARDS)
    src = [i for i in range(ec.TOTAL_SHARDS) if i not in lost][
        :ec.DATA_SHARDS]
    out = _net_leg(port, holders, work, lost, res["shas"],
                   f"net full rebuild {lost}", src, "full")
    st = out["stats"]
    if st["repair_fallback"] != "4 shards lost, trace repairs one" or \
            st["gather_remote_bytes"] != ec.DATA_SHARDS * res["shard_size"]:
        raise AssertionError(f"net full rebuild: fallback "
                             f"{st.get('repair_fallback')!r}, remote "
                             f"{st['gather_remote_bytes']} B")
    return out


def net_plane_leg(np, port, holders, work, res, pb, rplan):
    """Plane repair of the coupled data shard rplan.lost from the
    holders: exactly 0.55 of k x shard over the wire."""
    out = _net_leg(port, holders, work, (rplan.lost,), pb["shas"],
                   f"net plane repair shard {rplan.lost}", rplan.helpers,
                   "piggyback", 0.55)
    if out["stats"]["gather_remote_bytes"] != \
            len(rplan.helpers) * res["shard_size"] // 2:
        raise AssertionError("net plane repair moved "
                             f"{out['stats']['gather_remote_bytes']} B")
    return out


def net_degraded_leg(np, port, dev, holders, work, base, res, seed, label):
    """Degraded GETs with every survivor remote: an EcVolume over a
    directory holding only the .ecx and .vif, sized by a probe of a
    holder; the location map lists no holder for data shard NET_LOST, so
    its intervals are reconstructed from survivors pulled over HTTP."""
    ec, ops, _ = port
    from seaweedfs_tpu_torch.ec import gather
    d = os.path.join(work, "net-volume")
    os.makedirs(d)
    for ext in (".ecx", ".vif"):
        if os.path.exists(base + ext):
            shutil.copyfile(base + ext, os.path.join(d, "1" + ext))
    locs = holders.sources((NET_LOST,))
    sizes = gather.ShardSizeCache()
    ev = ec.EcVolume(d, "", 1, shard_size=sizes.get(1, 0, locs[0]))
    codec = ops.get_codec(ec.DATA_SHARDS, ec.PARITY_SHARDS, device=dev)
    eng = ec.DegradedReadEngine(_Store(ev), lambda vid: locs, lambda: codec,
                                self_url="smoke")
    try:
        out = _serve_degraded(np, port, base, res, ev, eng, NET_LOST,
                              base + ec.to_ext(NET_LOST), seed, label,
                              gets=NET_GETS)
    finally:
        ev.close()
        eng.close()
        shutil.rmtree(d, ignore_errors=True)
    snap = out["stats"]
    if snap["remote_bytes"] != snap["survivor_bytes"] or \
            snap["retries"] or sizes.probes != 1:
        raise AssertionError(f"{label}: remote {snap['remote_bytes']} of "
                             f"{snap['survivor_bytes']} survivor bytes, "
                             f"{snap['retries']} retries")
    return out


def net_scrub_leg(np, port, dev, holders, base, res, seed, label):
    """The scrub with survivors remote: the scrubber holds shard 0 (so it
    owns the volume) and reads 1-13 from the holders; the flipped byte
    lies in a seeded remote shard, flipped in every copy of it."""
    ec, ops, _ = port
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    ev = _mount(ec, base, skip=range(1, k + m))
    codec = ops.get_codec(k, m, device=dev)
    locs = holders.sources()
    eng = ec.ScrubEngine(_Store(ev), lambda vid: locs, lambda: codec,
                         lambda: "smoke", rate_mbps=0)
    rng = np.random.default_rng(seed)
    sid = int(rng.integers(1, k + m))
    off = int(rng.integers(0, res["shard_size"]))
    try:
        out = _scrub_drill(port, base, res, res["shas"], eng, sid, off,
                           holders.copies(sid), label)
    finally:
        ev.close()
    want = 2 * (k + m - 1) * res["shard_size"]
    if out["stats"]["remote_bytes"] != want:
        raise AssertionError(f"{label}: remote bytes "
                             f"{out['stats']['remote_bytes']}, want {want}")
    return out


def _post(url, target, body=None, timeout=60.0):
    from seaweedfs_tpu_torch.server.http_util import http_call
    return json.loads(http_call(
        "POST", f"http://{url}{target}",
        None if body is None else json.dumps(body).encode(),
        timeout=timeout))


def spread_holders(ec, work, base, layout):
    """The three holder processes of a spread leg, over empty directories,
    started (spawn_all) but not waited for."""
    return Holders(base, os.path.join(work, f"spread-{layout}"),
                   f"spread-{layout}", ec.TOTAL_SHARDS, holds=SPREAD_HOLDS,
                   empty=True).spawn_all()


def spread_leg(torch, port, work, base, res, shas, dat, layout, holders):
    """ec.encode over the network, through the port's own routes: an
    in-process source VolumeServer on the card over hard links to the
    seeded volume's .dat and .idx, three holder processes over empty
    directories (``holders``, from spread_holders, started while an
    earlier leg ran). POST /admin/volume/readonly, then /admin/ec/generate
    with the assignment (source SPREAD_LOCAL, holders SPREAD_HOLDS, no
    spares, the default window; traced for the card's busy share), then
    each holder's /admin/ec/copy (the .ecx and .vif) and /admin/ec/mount.
    Every shard sha256-identical to the local encode of the same layout
    at its holder, no .part anywhere, 12 shards remote and only the
    assigned holders sent to, spread_bytes 14 x shard, 12 x shard in
    the holders' files (they started empty), each holder's shards
    mounted, and the original .dat unchanged."""
    ec, ops, _ = port
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    label = f"spread {layout}"
    d = os.path.join(work, f"spread-{layout}")
    src = os.path.join(d, "src")
    os.makedirs(src)
    for ext in (".dat", ".idx"):
        _link(base + ext, os.path.join(src, "1" + ext))
    source = None
    try:
        holders.wait_all()
        source = VolumeServer(port=0, directories=[src], device="cuda",
                              layout=layout, scrub_idle_s=0,
                              fast_port=-1).start()
        if _post(source.url, "/admin/volume/readonly?volume=1") != {
                "volume": 1, "readonly": True, "was_readonly": False}:
            raise AssertionError(f"{label}: readonly refused")
        place = {sid: source.url for sid in SPREAD_LOCAL}
        place.update({sid: holders.urls[name]
                      for name, sids in SPREAD_HOLDS.items() for sid in sids})
        got = []

        def generate():
            t0 = time.perf_counter()
            got.append(_post(
                source.url, "/admin/ec/generate?volume=1",
                {"assignment": {str(s): u for s, u in place.items()}},
                timeout=900))
            got.append(time.perf_counter() - t0)

        trace = traced(torch, label, generate, base + ".spread.trace.json")
        out, wall = got
        mounted = {}
        for name, sids in SPREAD_HOLDS.items():
            url = holders.urls[name]
            copied = _post(url, f"/admin/ec/copy?volume=1&source="
                                f"{source.url}&copy_ecx=true&shards=")
            if copied["copied"] != [".ecx", ".vif"]:
                raise AssertionError(f"{label}: holder {name} copied "
                                     f"{copied}")
            mounted[name] = _post(url, "/admin/ec/mount?volume=1&shards="
                                  + ",".join(map(str, sids)))["mounted"]
    finally:
        if source is not None:
            source.stop()
        holders.stop_processes()
    st = out["stats"]
    size = res["shard_size"]
    where = {sid: src for sid in SPREAD_LOCAL}
    where.update({sid: holders.dirs[name]
                  for name, sids in SPREAD_HOLDS.items() for sid in sids})
    # the original .dat hashed beside the shards
    got = _shas([os.path.join(dirpath, "1" + ec.to_ext(sid))
                 for sid, dirpath in where.items()] + [base + ".dat"])
    dat_sha = got.pop()
    for (sid, _), sha in zip(where.items(), got):
        if sha != shas[sid]:
            raise AssertionError(f"{label}: shard {sid} at its holder "
                                 f"differs from the local encode's")
    dirs = [src] + list(holders.dirs.values())
    parts = [f for p in dirs for f in os.listdir(p) if f.endswith(".part")]
    held = sum(os.path.getsize(os.path.join(holders.dirs[name],
                                            "1" + ec.to_ext(sid)))
               for name, sids in SPREAD_HOLDS.items() for sid in sids)
    remote = ec.TOTAL_SHARDS - len(SPREAD_LOCAL)
    for name in SPREAD_HOLDS:
        for ext in (".ecx", ".vif"):
            if _sha(os.path.join(holders.dirs[name], "1" + ext)) != \
                    _sha(os.path.join(src, "1" + ext)):
                raise AssertionError(f"{label}: holder {name}'s {ext} "
                                     f"differs from the source's")
    sends = st["holder_fetches"]
    if parts or st["spread_remote_shards"] != remote or \
            st["shard_size"] != size or \
            st["spread_bytes"] != ec.TOTAL_SHARDS * size or \
            held != remote * size or \
            set(sends) != set(holders.urls.values()) or \
            min(sends.values()) < 1 or \
            sum(sends.values()) > st["spread_sends"] or \
            st["spread_retries"] or st["holder_errors"] or \
            st["spread_stripes"] != res["n_slabs"] or \
            out["assignment"] != {str(s): "" if u == source.url else u
                                  for s, u in place.items()} or \
            mounted != {name: list(sids)
                        for name, sids in SPREAD_HOLDS.items()}:
        raise AssertionError(f"{label}: parts {parts}, stats {st}, "
                             f"{held} B held, mounted {mounted}, "
                             f"assignment {out['assignment']}")
    if os.path.getsize(base + ".dat") != dat["size"] or \
            dat_sha != dat["sha"]:
        raise AssertionError(f"{label}: the original .dat changed")
    numbers = {
        "wall_s": round(wall, 3), "stream_s": st["stream_s"],
        "encode_busy_s": st["encode_busy_s"],
        "spread_busy_s": st["spread_busy_s"],
        "overlap_frac": st["overlap_frac"],
        "peak_spread_buffer": st["peak_spread_buffer"],
        "blocked_s": round(st["stream_s"] - st["encode_busy_s"], 3),
        "spread_mbps": st["spread_mbps"], "spread_sends": st["spread_sends"],
        "spread_bytes": st["spread_bytes"], "to_holders_bytes": held,
        "sends_by_holder": holders.names(sends), "phases": st["phases"],
        "dispatches": st["dispatches"],
        "card_busy_share": None if trace is None else
        round(trace["busy_share"], 5)}
    print(f"{label}: {json.dumps(numbers)}")
    print(f"{label}: {dat['size'] / wall / 1e6:.1f} MB/s of .dat over "
          f"{wall:.2f} s; {held} B to the holders over HTTP, shards 0-1 "
          f"kept; every shard sha256-identical at its holder, sidecars "
          f"copied, {sum(len(v) for v in mounted.values())} shards mounted, "
          f"no .part, the original .dat unchanged")
    shutil.rmtree(d, ignore_errors=True)
    return numbers


def crc_phase(np, crc):
    """The compiled CRC32-C (storage/crc.py over csrc/crc32c.cc, built
    with the kernels) against its plain version on seeded inputs of
    CRC_SIZES bytes, whole and chained from a third of the way, and its
    slicing-by-8 path beside its dispatching entry; then the compiled
    CRC's rate over 256 MiB and the plain version's over CRC_PLAIN_BYTES.
    Returns {"compiled_mb_s", "plain_mb_s", "hardware_path"}."""
    rng = np.random.default_rng(5)
    for size in CRC_SIZES:
        data = rng.bytes(size)
        want = crc.crc32c_plain(data)
        cut = size // 3
        got = (crc.crc32c(data), crc.crc32c_sliced(data),
               crc.crc32c(data[cut:], crc.crc32c(data[:cut])))
        if any(g != want for g in got):
            raise AssertionError(f"crc32c of {size} B: {got} != plain "
                                 f"{want:#x}")
    big = rng.bytes(256 << 20)
    t0 = time.perf_counter()
    crc.crc32c(big)
    compiled = len(big) / (time.perf_counter() - t0) / 1e6
    plain_in = rng.bytes(CRC_PLAIN_BYTES)
    t0 = time.perf_counter()
    crc.crc32c_plain(plain_in)
    plain = len(plain_in) / (time.perf_counter() - t0) / 1e6
    out = {"compiled_mb_s": round(compiled, 1), "plain_mb_s": round(plain, 2),
           "hardware_path": crc.hardware_path()}
    print(f"crc32c: compiled = plain on {list(CRC_SIZES)} B (whole, chained, "
          f"slicing-by-8 and dispatching entries); compiled "
          f"{compiled:.1f} MB/s over 256 MiB (SSE4.2 path: "
          f"{out['hardware_path']}), plain {plain:.2f} MB/s over "
          f"{len(plain_in)} B")
    return out


def _needle_plan(np, seed, total):
    """(fid, filename, content type, pairs, data seed, size) of seeded
    needles, sizes log-uniform over DATA_MIN..DATA_MAX, until their data
    reaches ``total`` bytes. Every needle has a name; a third give a
    mime, a third octet-stream, a third leave it to the name's extension
    (text/plain); every fifth carries a Seaweed-* pair."""
    rng = np.random.default_rng(seed)
    plan, acc, i = [], 0, 0
    lo, hi = math.log(DATA_MIN), math.log(DATA_MAX)
    while acc < total:
        size = min(int(math.exp(rng.uniform(lo, hi))), total - acc)
        key = int(rng.integers(1, 1 << 48))
        cookie = int(rng.integers(0, 1 << 32))
        fid = f"{DATA_VID},{key:x}{cookie:08x}"
        kind = i % 3
        name, ctype = (f"needle-{i}.jpg", "image/jpeg") if kind == 0 else \
            (f"needle-{i}.bin", "application/octet-stream") if kind == 1 \
            else (f"needle-{i}.txt", "")
        pairs = {"Seaweed-Seq": str(i)} if i % 5 == 0 else None
        plan.append((fid, name, ctype, pairs, (seed, i), max(size, 1)))
        acc += size
        i += 1
    return plan


def _timed_gets(url, fids, want, threads=DEGRADED_THREADS):
    """GET every fid from ``threads`` threads; each body's sha256 and
    Etag must be ``want[fid]``. Returns (wall s, bytes, latencies ms)."""
    from seaweedfs_tpu_torch.server.http_util import http_get_with_headers

    def get(fid):
        t0 = time.perf_counter()
        body, headers = http_get_with_headers(f"http://{url}/{fid}",
                                              timeout=120)
        secs = time.perf_counter() - t0
        sha, etag = want[fid]
        if hashlib.sha256(body).hexdigest() != sha or \
                headers.get("Etag") != f'"{etag}"':
            raise AssertionError(f"GET {fid}: body or Etag differs "
                                 f"({headers.get('Etag')} != {etag})")
        return secs * 1e3, len(body)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        got = list(pool.map(get, fids))
    return time.perf_counter() - t0, sum(n for _, n in got), \
        [ms for ms, _ in got]


def _gone(url, fids):
    """Every fid must answer 404."""
    from seaweedfs_tpu_torch.server.http_util import HttpError, http_call
    for fid in fids:
        try:
            http_call("GET", f"http://{url}/{fid}")
        except HttpError as e:
            if e.status == 404:
                continue
            raise
        raise AssertionError(f"GET {fid}: a deleted needle was served")


def data_plane_leg(np, port, work, seed):
    """A port volume server's needle data plane, end to end: an
    in-process VolumeServer on the card (127.0.0.1, an empty directory,
    RS(10,4), flat). /admin/assign_volume; DATA_THREADS threads POST the
    seeded needles (_needle_plan, about 250 over DATA_PLANE_BYTES) as
    multipart uploads in the plan's order (a thread sends needle j once
    needle j - 1 is answered: the .dat layout is the seed's); every needle GET back (sha256 and Etag); every
    tenth DELETEd and 404 after; the vacuum (check > 0, compact, commit,
    check 0; the .dat shrinks by exactly the deleted needles' actual
    sizes; every live needle read back); readonly, the query form of
    /admin/ec/generate, mount, delete_volume (K1 launches = the encode's
    dispatches = ceil(shard / 8 MiB)); every live needle GET from the EC
    volume with no launch; /admin/ec/delete_shards of DATA_LOST; the
    needles touching it GET from DEGRADED_THREADS threads, each parsed
    and its CRC checked by the server (launches = the engine's device
    dispatches > 0; p50, p99); the query form of /admin/ec/rebuild
    (launches = its dispatches; the shard sha256-identical to the one
    encoded), its mount, the same GETs again with no launch; DATA_EC_DELETES
    EC DELETEs, each 404 after and listed in the .ecj. Returns the leg's
    numbers (its own wall in leg_s) with its launches by phase."""
    ec, ops, storage = port
    from seaweedfs_tpu_torch.ops import telemetry
    from seaweedfs_tpu_torch.server.http_util import (http_call,
                                                      post_multipart)
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage import crc
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    d = os.path.join(work, "data-plane")
    os.makedirs(d)
    base = os.path.join(d, str(DATA_VID))
    plan = _needle_plan(np, seed, DATA_PLANE_BYTES)
    want = {}
    numbers = {"needles": len(plan)}
    launched = {}

    leg_t0 = time.perf_counter()

    def counted(name, fn):
        start = _k1()
        before = telemetry.STATS.snapshot()
        out = fn()
        launched[name] = (_k1() - start,
                          telemetry.delta(before)["dispatches"])
        return out

    vs = VolumeServer(port=0, directories=[d], device="cuda",
                      layout="flat", scrub_idle_s=0, fast_port=-1).start()
    url = vs.url
    try:
        if _post(url, f"/admin/assign_volume?volume={DATA_VID}") != {
                "volume": DATA_VID}:
            raise AssertionError("data plane: assign refused")

        turn = [0]
        turns = threading.Condition()

        def put(j):
            fid, name, ctype, pairs, dseed, size = plan[j]
            data = np.random.default_rng(dseed).bytes(size)
            etag = f"{crc.needle_checksum(data):08x}"
            with turns:
                if not turns.wait_for(lambda: turn[0] == j, timeout=600):
                    raise AssertionError(f"POST {fid}: needle {j - 1} "
                                         f"never answered")
            try:
                t0 = time.perf_counter()
                out = post_multipart(f"http://{url}/{fid}", name, data,
                                     ctype or "", headers=pairs,
                                     timeout=120)
                secs = time.perf_counter() - t0
            finally:
                with turns:
                    turn[0] += 1
                    turns.notify_all()
            if out != {"name": name, "size": size, "eTag": etag}:
                raise AssertionError(f"POST {fid}: {out}")
            want[fid] = (hashlib.sha256(data).hexdigest(), etag)
            return secs * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(DATA_THREADS) as pool:
            put_ms = list(pool.map(put, range(len(plan))))
        write_s = time.perf_counter() - t0
        data_bytes = sum(e[5] for e in plan)
        dat_written = os.path.getsize(base + ".dat")
        numbers.update(write_s=round(write_s, 3),
                       write_mb_s=round(data_bytes / write_s / 1e6, 1),
                       write_req_s=round(len(plan) / write_s, 1),
                       write_p50_ms=round(_pct(put_ms, 0.5), 3),
                       write_p99_ms=round(_pct(put_ms, 0.99), 3),
                       data_bytes=data_bytes, dat_bytes=dat_written)
        print(f"data plane: {len(plan)} needles ({data_bytes} B of data, "
              f"{DATA_MIN}-{DATA_MAX} B log-uniform) POSTed in the "
              f"plan's order from {DATA_THREADS} threads in "
              f"{write_s:.2f} s: "
              f"{numbers['write_mb_s']} MB/s, {numbers['write_req_s']} "
              f"requests/s, p50 {numbers['write_p50_ms']} ms, p99 "
              f"{numbers['write_p99_ms']} ms; .dat {dat_written} B")
        fids = [e[0] for e in plan]
        read_s, nbytes, _ = _timed_gets(url, fids, want, DATA_THREADS)
        numbers.update(read_s=round(read_s, 3),
                       read_mb_s=round(nbytes / read_s / 1e6, 1),
                       read_req_s=round(len(fids) / read_s, 1))
        print(f"data plane: every needle GET back in {read_s:.2f} s: "
              f"{numbers['read_mb_s']} MB/s, {numbers['read_req_s']} "
              f"requests/s, sha256 and Etag equal")

        # every tenth needle deleted, then the vacuum
        deleted = fids[::10]
        rec = storage.entry_size()
        with open(base + ".idx", "rb") as f:
            idx = f.read()
        sizes = {int.from_bytes(idx[i:i + 8], "big"):
                 int.from_bytes(idx[i + rec - 4:i + rec], "big")
                 for i in range(0, len(idx), rec)}
        freed = sum(get_actual_size(
            sizes[parse_file_id(fid)[1]], 3)
            for fid in deleted)
        for fid in deleted:
            http_call("DELETE", f"http://{url}/{fid}")
            want.pop(fid)
        _gone(url, deleted)
        live = [fid for fid in fids if fid in want]
        garbage = _post(url, f"/admin/vacuum/check?volume={DATA_VID}")
        t0 = time.perf_counter()
        _post(url, f"/admin/vacuum/compact?volume={DATA_VID}", timeout=600)
        _post(url, f"/admin/vacuum/commit?volume={DATA_VID}", timeout=600)
        vacuum_s = time.perf_counter() - t0
        after = _post(url, f"/admin/vacuum/check?volume={DATA_VID}")
        dat_vacuumed = os.path.getsize(base + ".dat")
        if not garbage["garbage"] > 0 or after["garbage"] != 0 or \
                dat_vacuumed != dat_written - freed:
            raise AssertionError(
                f"vacuum: garbage {garbage} -> {after}, .dat {dat_written} "
                f"-> {dat_vacuumed}, want -{freed}")
        _gone(url, deleted)
        _timed_gets(url, live, want, DATA_THREADS)
        numbers.update(deleted=len(deleted), vacuum_s=round(vacuum_s, 3),
                       garbage_before=garbage["garbage"], freed_bytes=freed)
        print(f"data plane: {len(deleted)} needles deleted (404 after); "
              f"vacuum {vacuum_s:.2f} s, garbage {garbage['garbage']:.5f} "
              f"-> 0, .dat {dat_written} -> {dat_vacuumed} B (exactly the "
              f"deleted needles' {freed} B); every live needle read back")

        # ec.encode: freeze, encode here on K1, mount, drop the volume
        _post(url, f"/admin/volume/readonly?volume={DATA_VID}")
        t0 = time.perf_counter()
        counted("encode", lambda: _post(
            url, f"/admin/ec/generate?volume={DATA_VID}", timeout=600))
        encode_s = time.perf_counter() - t0
        shard_size = os.path.getsize(base + ec.to_ext(0))
        n_slabs = math.ceil(shard_size / ec.encoder.DEFAULT_SLAB)
        lost_sha = _sha(base + ec.to_ext(DATA_LOST))
        all14 = ",".join(map(str, range(ec.TOTAL_SHARDS)))
        if _post(url, f"/admin/ec/mount?volume={DATA_VID}&shards={all14}")[
                "mounted"] != list(range(ec.TOTAL_SHARDS)) or \
                _post(url, f"/admin/delete_volume?volume={DATA_VID}") != {
                    "deleted": DATA_VID} or \
                launched["encode"] != (n_slabs, n_slabs):
            raise AssertionError(f"encode: launches, dispatches "
                                 f"{launched['encode']}, want {n_slabs}")
        numbers.update(encode_s=round(encode_s, 3), shard_size=shard_size,
                       encode_mb_s=round(dat_vacuumed / encode_s / 1e6, 1))
        print(f"data plane: readonly, generate {encode_s:.2f} s "
              f"({numbers['encode_mb_s']} MB/s of .dat, {n_slabs} K1 "
              f"launches = dispatches), mount, delete_volume")
        counted("ec reads", lambda: _timed_gets(url, live, want,
                                                DATA_THREADS))
        if launched["ec reads"][0]:
            raise AssertionError(f"EC reads launched {launched['ec reads']}")

        # shard DATA_LOST lost: its needles reconstructed on read
        if _post(url, f"/admin/ec/delete_shards?volume={DATA_VID}&shards="
                      f"{DATA_LOST}")["removed"] != [DATA_LOST]:
            raise AssertionError("delete_shards refused")
        ev = vs.store.find_ec_volume(DATA_VID)
        touching = [fid for fid in live if any(
            iv.to_shard_id_and_offset(ec.LARGE_BLOCK_SIZE,
                                      ec.SMALL_BLOCK_SIZE)[0] == DATA_LOST
            for iv in ev.locate_needle(
                parse_file_id(fid)[1])[2])]
        eng0 = vs.degraded.snapshot()
        deg_s, deg_bytes, lat = counted(
            "degraded", lambda: _timed_gets(url, touching, want))
        eng = vs.degraded.snapshot()
        dev_disp = eng["device_dispatches"] - eng0["device_dispatches"]
        if launched["degraded"] != (dev_disp, dev_disp) or dev_disp < 1 or \
                eng["errors"]:
            raise AssertionError(f"degraded GETs: launches, dispatches "
                                 f"{launched['degraded']}, engine {eng}")
        numbers.update(degraded_gets=len(touching),
                       degraded_p50_ms=round(_pct(lat, 0.5), 3),
                       degraded_p99_ms=round(_pct(lat, 0.99), 3),
                       degraded_mb_s=round(deg_bytes / deg_s / 1e6, 1),
                       degraded_host_dispatches=eng["host_dispatches"]
                       - eng0["host_dispatches"],
                       degraded_device_dispatches=dev_disp)
        print(f"data plane: shard {DATA_LOST} deleted; {len(touching)} "
              f"needle GETs through it from {DEGRADED_THREADS} threads in "
              f"{deg_s:.2f} s, p50 {numbers['degraded_p50_ms']} ms, p99 "
              f"{numbers['degraded_p99_ms']} ms, {numbers['degraded_mb_s']} "
              f"MB/s, each parsed and CRC-checked; {dev_disp} K1 launches = "
              f"device dispatches, {numbers['degraded_host_dispatches']} "
              f"host dispatches")

        t0 = time.perf_counter()
        out = counted("rebuild", lambda: _post(
            url, f"/admin/ec/rebuild?volume={DATA_VID}", timeout=600))
        rebuild_s = time.perf_counter() - t0
        if out["rebuilt"] != [DATA_LOST] or \
                _sha(base + ec.to_ext(DATA_LOST)) != lost_sha or \
                launched["rebuild"] != (out["stats"]["dispatches"],) * 2 or \
                out["stats"]["dispatches"] < 1:
            raise AssertionError(f"rebuild: {out}, launches "
                                 f"{launched['rebuild']}")
        _post(url, f"/admin/ec/mount?volume={DATA_VID}&shards={DATA_LOST}")
        counted("rebuilt reads", lambda: _timed_gets(url, touching, want))
        if launched["rebuilt reads"][0] or \
                vs.degraded.snapshot()["reads"] != eng["reads"]:
            raise AssertionError("reads after the rebuild reconstructed")
        numbers["rebuild_s"] = round(rebuild_s, 3)
        print(f"data plane: rebuild {rebuild_s:.2f} s "
              f"({out['stats']['dispatches']} K1 launches = dispatches), "
              f"shard {DATA_LOST} sha256-identical, mounted; the same GETs "
              f"read it from disk, no launch")

        gone = live[1:1 + DATA_EC_DELETES]
        for fid in gone:
            if http_call("DELETE", f"http://{url}/{fid}") != b'{"size": 0}':
                raise AssertionError(f"EC DELETE {fid} refused")
        _gone(url, gone)
        with open(base + ".ecj", "rb") as f:
            journal = f.read()
        if journal != b"".join(parse_file_id(fid)[1]
                               .to_bytes(8, "big") for fid in gone):
            raise AssertionError(f"the .ecj does not list the EC deletes: "
                                 f"{journal.hex()}")
        print(f"data plane: {len(gone)} EC DELETEs, 404 after, listed in "
              f"the .ecj")
    finally:
        vs.stop()
    numbers["launches"] = {name: n for name, (n, _) in launched.items()}
    numbers["leg_s"] = round(time.perf_counter() - leg_t0, 3)
    print(f"data plane: {json.dumps(numbers)}")
    shutil.rmtree(d, ignore_errors=True)
    return numbers


def _raw_get(hostport, path):
    """(status, body) of one GET, no redirect followed."""
    import http.client
    host, p = hostport.split(":")
    conn = http.client.HTTPConnection(host, int(p), timeout=120)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _loadgen(lg, port, paths, sizes=None, workdir="."):
    """One loadgen run against 127.0.0.1:``port``: multipart POSTs, each
    path once, when ``sizes`` are given, else GETs cycling the paths;
    NP_SECONDS at most, NP_THREADS connections. Its JSON line; any
    request that failed fails the step."""
    pf = os.path.join(workdir, "loadgen-paths")
    with open(pf, "w") as f:
        for i, path in enumerate(paths):
            f.write(f"/{path} {sizes[i]}\n" if sizes else f"/{path}\n")
    cmd = [str(lg), "127.0.0.1", str(port), str(NP_SECONDS),
           str(NP_THREADS), pf] + (["post", "1024"] if sizes else [])
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=NP_SECONDS + 120)
    if out.returncode != 0:
        raise AssertionError(f"loadgen failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if res["errors"] or not res["requests"]:
        raise AssertionError(f"loadgen: {res}")
    return res


def _loadgen_payload(np, max_size):
    """payload(i, size): the bytes loadgen uploads to its i-th path
    (csrc/loadgen.cc: pattern[o, o + size), o = i * 7919 mod 4096)."""
    n = max_size + 4096
    pattern = ((((np.arange(n, dtype=np.uint64) * 2654435761)
                 & 0xFFFFFFFF) % 26) + 97).astype(np.uint8).tobytes()
    return lambda i, size: pattern[(i * 7919) % 4096:
                                   (i * 7919) % 4096 + size]


def native_plane_leg(np, port, work, seed):
    """Step 19, the native data plane: an in-process master and a port
    VolumeServer on the card with its plane (csrc/http_plane.cc) on a
    second port, needle sizes from step 13's plan. (a) The plane is up,
    built from this checkout's csrc/ (not a library named in
    SW_HTTP_PLANE_LIB), and loadgen too. (b) Under each sync mode, off
    then group (set_sync_mode, the lease cycled), loadgen POSTs to the
    plane over batch-assigned fids for NP_SECONDS (NP_POST_BYTES at
    most), every 200 a fresh needle; every written needle read back
    sha256-identical; group: every acknowledged write a rider of a
    committed batch, at least one fdatasync timed per batch, none
    pending or failed; off: no batch. (c) loadgen GETs of those needles
    through the plane, then through the Python server. (d) JSON needles
    added, the volume encoded (readonly, generate, mount, delete_volume:
    launches = dispatches), shard DATA_LOST deleted; up to NP_COLD_GETS
    needles touching it (lost-shard slabs disjoint, readahead included,
    within NP_WARM_BYTES) GET cold through the plane: each 307, then
    reconstructed on K1 (launches = the engine's device dispatches > 0)
    and its bytes checked; again warm: each served by the plane (200),
    no K1 launch, no Python read, cache hits. (e) A file of three
    NP_CHUNK chunks: read whole through the plane and the master, by
    Range across a chunk boundary, deleted with its chunks. (f) /query
    over the JSON needles, through the lost shard, rows equal to a plain
    filter of the documents. (g) A server with -index disk: needles
    written by its plane, the server restarted, each read back. Returns
    the step's numbers with its launches by phase."""
    ec, ops, storage = port
    from seaweedfs_tpu_torch.client import chunked, operation as op
    from seaweedfs_tpu_torch.ops import telemetry
    from seaweedfs_tpu_torch.server import native_plane
    from seaweedfs_tpu_torch.server.http_util import (HttpError, http_call,
                                                      http_get_with_headers,
                                                      post_multipart)
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.types import (format_file_id,
                                                   parse_file_id)
    from seaweedfs_tpu_torch.util import config
    leg_t0 = time.perf_counter()
    d = os.path.join(work, "native-plane")
    os.makedirs(d)
    sizes = [e[5] for e in _needle_plan(np, seed, DATA_PLANE_BYTES)]
    payload = _loadgen_payload(np, max(sizes))
    numbers, launched, walls = {}, {}, {}
    mark_t0 = [leg_t0]

    def mark(name):
        walls[name] = round(time.perf_counter() - mark_t0[0], 3)
        mark_t0[0] = time.perf_counter()

    def counted(name, fn):
        start = _k1()
        before = telemetry.STATS.snapshot()
        out = fn()
        launched[name] = (_k1() - start,
                          telemetry.delta(before)["dispatches"])
        return out

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    # (a) the plane and loadgen, from this checkout's sources
    lib = native_plane._library_path()
    if native_plane.build_failed() or not native_plane.available() or \
            lib != native_plane.LIBRARY or \
            native_plane.stale(lib, native_plane.SOURCE) or \
            native_plane.stale(native_plane.LOADGEN,
                                native_plane.LOADGEN_SOURCE):
        raise AssertionError(f"native plane: not built from "
                             f"{native_plane.SOURCE} ({lib})")
    lg = native_plane.LOADGEN
    m = MasterServer(port=0, pulse_seconds=CLUSTER_PULSE_S, seed=seed,
                     repair_interval=0, vacuum_interval=0).start()
    vs = VolumeServer(port=0, directories=[d], device="cuda",
                      master_url=m.url, pulse_seconds=CLUSTER_PULSE_S,
                      max_volume_counts=[NP_SLOTS], scrub_idle_s=0).start()
    plane = vs.fast_plane
    try:
        if plane is None or not vs.fast_url:
            raise AssertionError("native plane: the server has no plane")
        print(f"native plane: {native_plane.LIBRARY.name} and loadgen built "
              f"from seaweedfs_tpu_torch/csrc/; the server's plane at "
              f"{vs.fast_url}, Python at {vs.url}")
        _post(vs.url, f"/admin/assign_volume?volume={NP_VID}")
        vs.heartbeat_once()
        if vs.store.find_volume(NP_VID).fast_writer is None:
            raise AssertionError("native plane: no write lease")
        mark("start")

        # (b) loadgen POSTs under off, then group
        written = []        # (fid, payload index, size)
        for mode in ("off", "group"):
            plane.set_sync_mode(
                mode, config.env_int("SW_PLANE_FSYNC_BATCH_US"),
                config.env_int("SW_PLANE_FSYNC_MAX_PENDING"))
            vs._fast_sync(NP_VID)       # a lease takes the mode it starts
            n, acc = 0, 0
            while acc < NP_POST_BYTES:
                acc += sizes[n % len(sizes)]
                n += 1
            a = op.assign(m.url, count=n)
            if a.get("fastUrl") != vs.fast_url or a["count"] != n or \
                    parse_file_id(a["fid"])[0] != NP_VID:
                raise AssertionError(f"batch assign: {a}")
            fids = list(op.expand_batch_fids(a["fid"], n))
            mode_sizes = [sizes[i % len(sizes)] for i in range(n)]
            s0, w0 = plane.sync_stats(), plane.written
            res = _loadgen(lg, plane.port, fids, mode_sizes, d)
            s1, w1 = plane.sync_stats(), plane.written
            done = res["written"]
            batches = s1["batches"] - s0["batches"]
            riders = s1["riders"] - s0["riders"]
            timed = sum(c for _, c in s1["buckets"]) - \
                sum(c for _, c in s0["buckets"])
            if s1["mode"] != mode or w1 - w0 != done or done < 1 or \
                    s1["failures"] or s1["pending"] or (
                        mode == "group" and (riders != done or batches < 1
                                             or timed < batches)) or (
                        mode == "off" and batches):
                raise AssertionError(f"POST {mode}: {res}, sync {s0} -> "
                                     f"{s1}, plane written {w1 - w0}")
            written += [(fids[i], i, mode_sizes[i]) for i in range(done)]
            numbers[f"post_{mode}"] = {
                "requests": res["requests"], "seconds": res["seconds"],
                "req_s": res["rps"], "mb_s": res["mb_s"],
                "p50_us": res["p50_us"], "p99_us": res["p99_us"],
                "batches": batches, "riders": riders,
                "riders_per_batch": round(riders / batches, 2)
                if batches else None,
                "fsyncs_per_batch": round(timed / batches, 2)
                if batches else None}
            print(f"native plane: POST under {mode}: {done} needles in "
                  f"{res['seconds']:.3f} s from {NP_THREADS} connections, "
                  f"{res['rps']} req/s, {res['mb_s']} MB/s, p50 "
                  f"{res['p50_us']} us, p99 {res['p99_us']} us; {batches} "
                  f"group commits for {riders} riders, {timed} fsyncs timed")

        def check(entry):
            fid, i, size = entry
            got = http_call("GET", f"http://{vs.fast_url}/{fid}", timeout=120)
            if sha(got) != sha(payload(i, size)):
                raise AssertionError(f"GET {fid}: not the bytes written")

        mark("POSTs")
        with ThreadPoolExecutor(NP_THREADS) as pool:
            list(pool.map(check, written))
        mark("read back")
        want = {fid: (i, size) for fid, i, size in written}
        print(f"native plane: all {len(written)} needles written by the "
              f"plane read back sha256-identical")

        # (c) loadgen GETs through the plane, then through Python
        for where, p in (("plane", plane.port), ("python", vs.port)):
            res = _loadgen(lg, p, [f for f, _, _ in written], None, d)
            numbers[f"get_{where}"] = {
                "requests": res["requests"], "seconds": res["seconds"],
                "req_s": res["rps"], "mb_s": res["mb_s"],
                "p50_us": res["p50_us"], "p99_us": res["p99_us"]}
            print(f"native plane: GET through the {where}: {res['rps']} "
                  f"req/s, {res['mb_s']} MB/s, p50 {res['p50_us']} us, p99 "
                  f"{res['p99_us']} us over {res['seconds']:.3f} s")

        mark("GETs")
        # JSON-lines needles for (f), appended through Python's path
        rng = np.random.default_rng(seed)
        docs = {}
        a = op.assign(m.url, count=NP_JSON_NEEDLES)
        for j, fid in enumerate(op.expand_batch_fids(a["fid"],
                                                     NP_JSON_NEEDLES)):
            rows = [{"id": j * NP_JSON_ROWS + r,
                     "v": int(x), "pad": "p" * 150}
                    for r, x in enumerate(rng.integers(0, 1000,
                                                       NP_JSON_ROWS))]
            body = ("\n".join(json.dumps(r) for r in rows) + "\n").encode()
            post_multipart(f"http://{vs.url}/{fid}", f"rows-{j}.jsonl",
                           body, "application/json")
            docs[fid] = rows

        mark("JSON needles")
        # (d) encode, lose DATA_LOST, cold then warm GETs through the plane
        _post(vs.url, f"/admin/volume/readonly?volume={NP_VID}")
        base = os.path.join(d, str(NP_VID))
        t0 = time.perf_counter()
        counted("encode", lambda: _post(
            vs.url, f"/admin/ec/generate?volume={NP_VID}", timeout=600))
        encode_s = time.perf_counter() - t0
        n_slabs = math.ceil(os.path.getsize(base + ec.to_ext(0))
                            / ec.encoder.DEFAULT_SLAB)
        all14 = ",".join(map(str, range(ec.TOTAL_SHARDS)))
        _post(vs.url, f"/admin/ec/mount?volume={NP_VID}&shards={all14}")
        _post(vs.url, f"/admin/delete_volume?volume={NP_VID}")
        if launched["encode"] != (n_slabs, n_slabs):
            raise AssertionError(f"encode: {launched['encode']}, want "
                                 f"{n_slabs}")
        if _post(vs.url, f"/admin/ec/delete_shards?volume={NP_VID}&shards="
                         f"{DATA_LOST}")["removed"] != [DATA_LOST]:
            raise AssertionError("delete_shards refused")
        ev = vs.store.find_ec_volume(NP_VID)
        slab = vs.degraded.slab

        def lost_slabs(fid):
            """The slabs of DATA_LOST a read of fid reconstructs, and the
            readahead slab after each run."""
            out = set()
            for iv in ev.locate_needle(parse_file_id(fid)[1])[2]:
                sid, off = iv.to_shard_id_and_offset(ec.LARGE_BLOCK_SIZE,
                                                     ec.SMALL_BLOCK_SIZE)
                if sid == DATA_LOST:
                    out.update(range(off // slab,
                                     (off + iv.size - 1) // slab + 2))
            return out

        cold, taken = [], set()
        for fid, _, _ in written:
            slabs = lost_slabs(fid)
            if slabs and not slabs & taken and \
                    (len(taken) + len(slabs)) * slab <= NP_WARM_BYTES:
                cold.append(fid)
                taken |= slabs
                if len(cold) == NP_COLD_GETS:
                    break
        cs0, eng0 = plane.cache_stats(), vs.degraded.snapshot()

        def cold_gets():
            lat = []
            for fid in cold:
                t0 = time.perf_counter()
                if _raw_get(vs.fast_url, f"/{fid}")[0] != 307:
                    raise AssertionError(f"cold GET {fid}: not redirected")
                body, _ = http_get_with_headers(f"http://{vs.url}/{fid}",
                                                timeout=120)
                lat.append((time.perf_counter() - t0) * 1e3)
                if sha(body) != sha(payload(*want[fid])):
                    raise AssertionError(f"cold GET {fid}: wrong bytes")
            return lat

        mark("encode")
        cold_ms = counted("degraded", cold_gets)
        cs1, eng1 = plane.cache_stats(), vs.degraded.snapshot()
        dev = eng1["device_dispatches"] - eng0["device_dispatches"]
        if not cold or launched["degraded"] != (dev, dev) or dev < 1 or \
                eng1["errors"] or \
                cs1["degraded_redirected"] - cs0["degraded_redirected"] \
                != len(cold) or cs1["puts"] <= cs0["puts"]:
            raise AssertionError(f"cold GETs: launches, dispatches "
                                 f"{launched['degraded']}, engine {eng1}, "
                                 f"cache {cs0} -> {cs1}")

        def warm_gets():
            lat = []
            for fid in cold:
                t0 = time.perf_counter()
                st, body = _raw_get(vs.fast_url, f"/{fid}")
                lat.append((time.perf_counter() - t0) * 1e3)
                if st != 200 or sha(body) != sha(payload(*want[fid])):
                    raise AssertionError(f"warm GET {fid}: {st}")
            return lat

        mark("cold GETs")
        served0 = plane.served
        warm_ms = counted("warm", warm_gets)
        cs2 = plane.cache_stats()
        if launched["warm"][0] or plane.served - served0 != len(cold) or \
                cs2["degraded_served"] - cs1["degraded_served"] != \
                len(cold) or cs2["hits"] <= cs1["hits"] or \
                vs.degraded.snapshot()["reads"] != eng1["reads"]:
            raise AssertionError(f"warm GETs: launches {launched['warm']}, "
                                 f"cache {cs1} -> {cs2}")
        numbers.update(
            encode_s=round(encode_s, 3), lost_gets=len(cold),
            cold_p50_ms=round(_pct(cold_ms, 0.5), 3),
            cold_p99_ms=round(_pct(cold_ms, 0.99), 3),
            warm_p50_ms=round(_pct(warm_ms, 0.5), 3),
            warm_p99_ms=round(_pct(warm_ms, 0.99), 3),
            cold_k1_launches=dev,
            cache_hits=cs2["hits"] - cs1["hits"],
            cache_puts=cs1["puts"] - cs0["puts"])
        print(f"native plane: encoded in {encode_s:.2f} s ({n_slabs} K1 "
              f"launches = dispatches), shard {DATA_LOST} deleted; "
              f"{len(cold)} GETs through it, cold (each 307, rebuilt on K1: "
              f"{dev} launches = device dispatches, {numbers['cache_puts']} "
              f"slabs published) p50 {numbers['cold_p50_ms']} ms, p99 "
              f"{numbers['cold_p99_ms']} ms; warm (each served by the "
              f"plane, no launch, {numbers['cache_hits']} cache hits) p50 "
              f"{numbers['warm_p50_ms']} ms, p99 {numbers['warm_p99_ms']} ms")

        mark("warm GETs")
        # (f) /query through the lost shard
        touching = [f for f in docs if lost_slabs(f)]
        ask = {"fids": list(docs),
               "sql": "SELECT id, v FROM S3Object WHERE v > 990"}
        reads0 = vs.degraded.snapshot()["reads"]
        got = counted("query", lambda: http_call(
            "POST", f"http://{vs.url}/query", json.dumps(ask).encode(),
            timeout=120))
        expect = [{"id": r["id"], "v": r["v"]} for f in docs for r in docs[f]
                  if r["v"] > 990]
        rows = [json.loads(line) for line in got.decode().splitlines()]
        if rows != expect or not touching or \
                vs.degraded.snapshot()["reads"] <= reads0 or \
                launched["query"][0] != launched["query"][1]:
            raise AssertionError(f"/query: {len(rows)} rows, want "
                                 f"{len(expect)}; {len(touching)} needles "
                                 f"on the lost shard, {launched['query']}")
        print(f"native plane: /query over {len(docs)} JSON needles "
              f"({len(touching)} through shard {DATA_LOST}): {len(rows)} "
              f"rows = a plain filter of the documents")

        mark("query")
        # (e) a chunked file: three chunks and a manifest
        data = np.random.default_rng(seed + 1).bytes(3 * NP_CHUNK - 1000)
        fid = chunked.submit_chunked(m.url, data, filename="chunked.bin",
                                     chunk_size=NP_CHUNK,
                                     content_type="application/x-smoke")
        manifest = json.loads(http_call("GET",
                                        f"http://{vs.url}/{fid}?cm=false"))
        lo, hi = NP_CHUNK - 100, 2 * NP_CHUNK + 99
        if len(manifest["chunks"]) != 3 or \
                http_call("GET", f"http://{vs.fast_url}/{fid}") != data or \
                op.read_file(m.url, fid) != data or \
                http_call("GET", f"http://{vs.url}/{fid}", headers={
                    "Range": f"bytes={lo}-{hi}"}) != data[lo:hi + 1]:
            raise AssertionError("chunked file: read back differs")
        op.delete_file(m.url, fid)
        for f in [fid] + [c["fid"] for c in manifest["chunks"]]:
            try:
                http_call("GET", f"http://{vs.url}/{f}")
            except HttpError as e:
                if e.status == 404:
                    continue
                raise
            raise AssertionError(f"chunked file: {f} served after delete")
        print(f"native plane: a {len(data)} B file in 3 chunks and a "
              f"manifest, read whole (plane and master) and by Range, "
              f"deleted with its chunks")
        mark("chunked")
    finally:
        vs.stop()
        m.stop()

    # (g) -index disk: the plane writes, the server restarts cold
    dd = os.path.join(work, "native-plane-disk")
    os.makedirs(dd)
    disk_want = {}
    vs = VolumeServer(port=0, directories=[dd], device="cuda",
                      index_kind="disk", scrub_idle_s=0).start()
    try:
        _post(vs.url, f"/admin/assign_volume?volume={NP_VID}")
        for i in range(NP_DISK_NEEDLES):
            f = format_file_id(NP_VID, i + 1, 0x5EED)
            body = payload(i, min(sizes[i % len(sizes)], 256 << 10))
            post_multipart(f"http://{vs.fast_url}/{f}", "d", body)
            disk_want[f] = sha(body)
        if vs.fast_plane.written != NP_DISK_NEEDLES:
            raise AssertionError("-index disk: the plane did not write")
    finally:
        vs.stop()
    vs = VolumeServer(port=0, directories=[dd], device="cuda",
                      index_kind="disk", scrub_idle_s=0).start()
    try:
        v = vs.store.find_volume(NP_VID)
        if v.index_kind != "disk" or v.file_count() != NP_DISK_NEEDLES or \
                not os.path.exists(os.path.join(dd, f"{NP_VID}.ndb")) or \
                any(sha(http_call("GET", f"http://{vs.fast_url}/{f}"))
                    != s for f, s in disk_want.items()):
            raise AssertionError("-index disk: a needle differs after the "
                                 "restart")
    finally:
        vs.stop()
    print(f"native plane: -index disk, {NP_DISK_NEEDLES} needles written by "
          f"the plane read back after a cold restart")
    mark("-index disk")
    numbers["launches"] = {name: n for name, (n, _) in launched.items()}
    numbers["walls"] = walls
    numbers["leg_s"] = round(time.perf_counter() - leg_t0, 3)
    print(f"native plane: {json.dumps(numbers)}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(dd, ignore_errors=True)
    return numbers


class VolumeProcesses(ServerProcesses):
    """Cluster volume servers as processes (``--master``), each over an
    empty directory ``<prefix>-<name>`` with ``slots[name]`` slots and
    CLUSTER_PULSE_S heartbeats, and ``args`` passed on."""

    def __init__(self, work, master_url, slots=CLUSTER_SLOTS,
                 prefix="cluster", args=()):
        super().__init__()
        self.work = work
        self.master_url = master_url
        self.slots = slots
        self.prefix = prefix
        self.args = tuple(args)

    def start(self, names):
        return self.spawn_all(names).wait_listening(names)

    def spawn_all(self, names):
        """Start the processes without waiting for them."""
        for name in names:
            d = os.path.join(self.work, f"{self.prefix}-{name}")
            os.makedirs(d)
            self.spawn(name, d, "--master", self.master_url,
                       "--max", str(self.slots[name]),
                       "--pulse-seconds", str(CLUSTER_PULSE_S), *self.args)
        return self


def _free_ports(n):
    """``n`` distinct ports free on 127.0.0.1 just now."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _wait_for(what, pred, timeout):
    """Poll ``pred`` every 50 ms until it holds; seconds waited, or fail
    after ``timeout``."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.05)
    return time.monotonic() - t0


def _raft_leader(masters):
    """The one master of ``masters`` that leads and that every other one
    names, else None."""
    leaders = [m for m in masters if m.is_leader()]
    if len(leaders) == 1 and all(m.leader_url() == leaders[0].url
                                 for m in masters):
        return leaders[0]
    return None


def _shell(master_url, line):
    """One line through the port shell; its printed lines. A line that
    reports an error or a fallback (a stream that failed and was redone
    by whole-shard copies) fails the run: the streamed path is the one
    under test."""
    import io
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    out = io.StringIO()
    run_command(CommandEnv(master_url, out=out), line)
    text = out.getvalue()
    print("  shell> " + line + "\n" + "".join(
        f"    {ln}\n" for ln in text.splitlines()), end="")
    if "error:" in text or "falling back" in text:
        raise AssertionError(f"{line}: {text}")
    return text


def _plain_card_codec(np, ec):
    """RS(DATA_SHARDS, PARITY_SHARDS) whose product is K1's plain PyTorch
    version on the card: the reference the cluster's shards are held to,
    independent of K1 and launching nothing."""
    import torch
    from seaweedfs_tpu_torch.ops.codec import NumpyCodec
    from seaweedfs_tpu_torch.ops.rs_hopper import gf_matmul_plain

    class PlainCardCodec(NumpyCodec):
        def _matmul(self, coeffs, data):
            return gf_matmul_plain(
                torch.from_numpy(np.ascontiguousarray(coeffs)).cuda(),
                torch.from_numpy(np.ascontiguousarray(data)).cuda()
            ).cpu().numpy()

    return PlainCardCodec(ec.DATA_SHARDS, ec.PARITY_SHARDS)


def cluster_servers(np, work, seed):
    """Step 14's raft group of CLUSTER_MASTERS in-process masters (no
    repair, vacuum or maintenance loop: one firing inside the leg would
    race its commands), a leader elected, volume server A in-process on
    the card and B spawned as a process, both given the masters with the
    leader first; run() calls it with step 16's ranks, so that B's
    start-up overlaps steps 16 to 19. Returns what cluster_leg takes as
    ``early``."""
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    jwt_key = np.random.default_rng(seed).bytes(16).hex()
    ports = _free_ports(CLUSTER_MASTERS)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    raft_dir = os.path.join(work, "cluster-raft")
    masters = [MasterServer(port=p, pulse_seconds=CLUSTER_PULSE_S,
                            seed=seed + i, repair_interval=0,
                            vacuum_interval=0, peers=peers,
                            raft_dir=raft_dir, jwt_signing_key=jwt_key,
                            whitelist=["127.0.0.1"]).start()
               for i, p in enumerate(ports)]
    elect_s = _wait_for("a raft leader", lambda: _raft_leader(masters),
                        ELECTION_WAIT_S)
    leader = _raft_leader(masters)
    follower, other = [m for m in masters if m is not leader]
    # the leader first: a server's location map is bound to its first seed
    seeds = ",".join([leader.url, follower.url, other.url])
    print(f"cluster: {CLUSTER_MASTERS} masters in a raft group, leader "
          f"{leader.url} elected in {elect_s:.3f} s; clients and the shell "
          f"through the follower {follower.url}; write JWTs and the "
          f"whitelist 127.0.0.1 on every master and server")
    d_a = os.path.join(work, "cluster-A")
    os.makedirs(d_a)
    a = VolumeServer(port=0, directories=[d_a], device="cuda",
                     master_url=seeds, pulse_seconds=CLUSTER_PULSE_S,
                     max_volume_counts=[CLUSTER_SLOTS["A"]],
                     scrub_idle_s=0, jwt_signing_key=jwt_key,
                     whitelist=["127.0.0.1"], fast_port=-1).start()
    procs = VolumeProcesses(work, seeds, args=(
        "--jwt-key", jwt_key, "--whitelist", "127.0.0.1"))
    procs.spawn_all(["B"])
    return {"jwt_key": jwt_key, "masters": masters, "leader": leader,
            "follower": follower, "raft_dir": raft_dir, "d_a": d_a, "a": a, "procs": procs,
            "elect_s": round(elect_s, 3)}


def cluster_leg(np, port, work, seed, early=None):
    """A port cluster on 127.0.0.1, end to end, through the entry points
    its users call: CLUSTER_MASTERS in-process MasterServers in a raft
    group (pulse CLUSTER_PULSE_S, seeded, write tokens, the whitelist),
    clients and the shell through a follower; volume server A in-process
    on the card with the most slots, B as a process, both given the
    masters with the leader first; one 001 volume grown in
    CLUSTER_COLLECTION while only A and B are registered, so its replicas
    are on both; then C and D as processes (started while the writes
    run; registered before the encode). The masters run no repair loop.
    CLUSTER_THREADS client threads assign and upload seeded needles
    (_needle_plan's sizes, names
    and types) through client/operation until CLUSTER_BYTES of data, each
    reply's size and
    ETag checked; every needle read back from A and from B (the
    locations /dir/lookup gives) and through the master's GET /<fid>
    redirect; a full backup; every tenth deleted through the client, 404
    on both after; an incremental backup (the tombstones only; every
    needle checked in the copy); volume.vacuum (exactly the deleted
    records and tombstones reclaimed on A and B, reads after);
    volume.fsck -deep; volume.move B -> C. Both replicas (A, C) frozen
    and A's compacted .dat and .idx linked aside; ec.encode
    through the port shell, which must name A as the source: 14 shards
    over A-D in /cluster/ec_status, the volume gone from A and B, every
    shard sha256-identical to a local write_ec_files of A's frozen .dat
    through K1's plain version on the card (no launch), A's K1
    launches = the encode's dispatches. The process of B-D holding the
    most shards is killed (SIGKILL) and the master's prune awaited
    (bounded); the live needles touching its shards GET from A from
    DEGRADED_THREADS threads (launches = A's degraded engine's device
    dispatches > 0; p50, p99). The leader stopped: a new one elected, the
    servers registered with it, its shard map the old one's; a /vol/grow
    and ID_ASSIGNS assigns through the follower, every id above the
    earlier ones. ec.rebuild, which must name A: 14 shards
    mounted, every rebuilt shard sha256-identical, launches = the
    rebuild's dispatches > 0; ec.balance: 14 shards, each at its holder
    sha256-identical; every live needle read through the live servers in
    turn, with no launch on A (the counter read is A's); ec.decode: every
    live needle read through /dir/lookup, the volume out of
    /cluster/ec_status; unmount and mount of its one replica,
    volume.fix.replication, volume.fsck -deep; /submit into a second
    collection and its collection.delete. Prints each
    step's wall and rates on a line of its own and the leg's numbers as
    JSON; stops every process and removes its directories in a
    finally."""
    ec, ops, storage = port
    import http.client
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.command import volume_tools
    from seaweedfs_tpu_torch.ops import telemetry
    from seaweedfs_tpu_torch.security.jwt import GenJwt
    from seaweedfs_tpu_torch.server.http_util import (HttpError, get_json,
                                                      http_call, post_json,
                                                      post_multipart)
    from seaweedfs_tpu_torch.storage import crc, volume_backup
    from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
    from seaweedfs_tpu_torch.storage.types import (CURRENT_VERSION,
                                                   parse_file_id)
    from seaweedfs_tpu_torch.storage.volume import NotFound, Volume
    plan = _needle_plan(np, seed, CLUSTER_BYTES)
    numbers = {"needles": len(plan)}
    launched = {}
    want = {}
    leg_t0 = time.perf_counter()

    def counted(name, fn):
        start = _k1()
        before = telemetry.STATS.snapshot()
        out = fn()
        launched[name] = (_k1() - start,
                          telemetry.delta(before)["dispatches"])
        return out

    if early is None:
        early = cluster_servers(np, work, seed)
    (jwt_key, masters, leader, follower, raft_dir, d_a, a, procs) = (
        early[k] for k in ("jwt_key", "masters", "leader", "follower",
                           "raft_dir", "d_a", "a", "procs"))
    live_masters = list(masters)
    issued = []    # every file key assigned before the failover
    # clients and the shell go through a follower: every call forwarded
    murl = follower.url
    numbers["elect_s"] = early["elect_s"]

    def key_of(fid):
        return parse_file_id(fid)[1]

    ref_dir = os.path.join(work, "cluster-reference")
    bk_dir = os.path.join(work, "cluster-backup")

    def nodes():
        return {n["url"] for n in
                get_json(f"http://{murl}/cluster/status")["nodes"]}

    def ec_shards(vid):
        vols = get_json(f"http://{murl}/cluster/ec_status")["volumes"]
        return {int(s): urls for s, urls in
                vols.get(str(vid), {}).get("shards", {}).items()}

    def replica_info(vid):
        """url -> the master's info of each replica of ``vid``."""
        vols = get_json(f"http://{murl}/cluster/volumes")["volumes"]
        return {r["url"]: r for r in vols.get(str(vid), [])}

    def fsck_deep(names):
        """volume.fsck -deep: each named replica checks every live needle
        with no error; the wall."""
        t0 = time.perf_counter()
        out = _shell(murl, "volume.fsck -deep")
        secs = time.perf_counter() - t0
        for name in names:
            if f"volume {vid} @ {urls[name]}: checked={len(live)} " \
                    f"errors=0" not in out:
                raise AssertionError(f"fsck -deep on {name}: {out}")
        if "0 with errors" not in out:
            raise AssertionError(f"fsck -deep: {out}")
        return secs

    def dat_path(name, vid):
        base = a.store.find_volume(vid).file_name() if name == "A" else \
            os.path.join(procs.dirs[name], f"{CLUSTER_COLLECTION}_{vid}")
        return base + ".dat"

    try:
        t0 = time.perf_counter()
        procs.wait_listening(["B"])
        urls = {"A": a.url, "B": procs.urls["B"]}
        _wait_for("A and B registered", lambda: nodes() == set(
            urls.values()), HOLDER_START_S)
        grown = post_json(f"http://{murl}/vol/grow?collection="
                          f"{CLUSTER_COLLECTION}&replication=001&count=1")
        vols = get_json(f"http://{murl}/cluster/volumes")["volumes"]
        (vid_s, replicas), = vols.items()
        vid = int(vid_s)
        if grown != {"count": 1} or \
                [r["url"] for r in replicas] != [urls["A"], urls["B"]]:
            raise AssertionError(f"the 001 volume: {grown}, {vols}")
        # C and D come up while the writes run: they need only A and B
        procs.spawn_all(["C", "D"])
        _wait_for("the replicas in A's location map", lambda: sorted(
            a._vid_map.lookup(vid) or []) == sorted([urls["A"],
                                                     urls["B"]]), 10.0)
        numbers["start_s"] = round(time.perf_counter() - t0, 3)
        print(f"cluster: master {murl}, A {urls['A']} "
              f"({CLUSTER_SLOTS['A']} slots, in-process on the card), B "
              f"{urls['B']} ({CLUSTER_SLOTS['B']} slots, a process); 001 "
              f"volume {vid} on A and B; up in {numbers['start_s']} s")

        # the writes: assign, then upload; the server fans out to B
        fids = [None] * len(plan)
        fanned = []

        def put(j):
            _, name, ctype, pairs, dseed, size = plan[j]
            data = np.random.default_rng(dseed).bytes(size)
            etag = f"{crc.needle_checksum(data):08x}"
            t0 = time.perf_counter()
            got = op.assign(murl, collection=CLUSTER_COLLECTION,
                            replication="001")
            issued.append(key_of(got["fid"]))
            out = post_multipart(f"http://{got['url']}/{got['fid']}", name,
                                 data, ctype or "",
                                 headers=dict(pairs or {}, Authorization=
                                              f"Bearer {got['auth']}"),
                                 timeout=120)
            secs = time.perf_counter() - t0
            if out != {"name": name, "size": size, "eTag": etag} or \
                    parse_file_id(got["fid"])[0] != vid:
                raise AssertionError(f"POST {got}: {out}")
            fids[j] = got["fid"]
            fanned.append(got["url"])
            want[got["fid"]] = (hashlib.sha256(data).hexdigest(), etag)
            return secs * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLUSTER_THREADS) as pool:
            put_ms = list(pool.map(put, range(len(plan))))
        write_s = time.perf_counter() - t0
        data_bytes = sum(e[5] for e in plan)
        numbers.update(
            write_s=round(write_s, 3),
            write_mb_s=round(data_bytes / write_s / 1e6, 1),
            write_req_s=round(len(plan) / write_s, 1),
            write_p50_ms=round(_pct(put_ms, 0.5), 3),
            write_p99_ms=round(_pct(put_ms, 0.99), 3),
            data_bytes=data_bytes,
            written_to={n: fanned.count(u) for n, u in urls.items()})
        print(f"cluster: {len(plan)} needles ({data_bytes} B) assigned and "
              f"POSTed from {CLUSTER_THREADS} threads in {write_s:.2f} s, "
              f"each fanned out to the other replica: "
              f"{numbers['write_mb_s']} MB/s, {numbers['write_req_s']} "
              f"requests/s, p50 {numbers['write_p50_ms']} ms, p99 "
              f"{numbers['write_p99_ms']} ms (assign + POST + fan-out); "
              f"POSTs by server {numbers['written_to']}")

        holders = sorted(op.lookup(murl, vid))
        if holders != sorted([urls["A"], urls["B"]]):
            raise AssertionError(f"/dir/lookup of {vid}: {holders}")
        reads = {}
        for name in ("A", "B"):
            reads[name] = _timed_gets(urls[name], fids, want,
                                      CLUSTER_THREADS)
        reads["redirect"] = _timed_gets(murl, fids, want, CLUSTER_THREADS)
        for name, (secs, nbytes, _) in reads.items():
            numbers[f"read_{name}_s"] = round(secs, 3)
            numbers[f"read_{name}_mb_s"] = round(nbytes / secs / 1e6, 1)
        print("cluster: every needle GET back sha256- and Etag-identical "
              "from " + ", ".join(
                  f"{'the master redirect' if n == 'redirect' else n} "
                  f"{numbers[f'read_{n}_mb_s']} MB/s ({s:.2f} s)"
                  for n, (s, _, _) in reads.items()))
        # the follower bounces a GET /<fid> to the leader, the leader to a
        # holder; a write without its token, or with another fid's, is
        # refused
        conn = http.client.HTTPConnection("127.0.0.1", follower.port,
                                          timeout=30)
        conn.request("GET", f"/{fids[0]}")
        resp = conn.getresponse()
        resp.read()
        conn.close()
        if resp.status != 301 or resp.getheader("Location") != \
                f"http://{leader.url}/{fids[0]}":
            raise AssertionError(f"the follower's redirect: {resp.status} "
                                 f"{resp.getheader('Location')}")
        probes = [op.assign(murl, collection=CLUSTER_COLLECTION,
                            replication="001") for _ in range(2)]
        issued += [key_of(probe["fid"]) for probe in probes]
        refused = []
        for headers in ({}, {"Authorization":
                             f"Bearer {probes[1]['auth']}"}):
            try:
                post_multipart(f"http://{urls['A']}/{probes[0]['fid']}",
                               "x", b"x", headers=headers)
            except HttpError as e:
                refused.append(e.status)
        if refused != [401, 401]:
            raise AssertionError(f"writes without their token: {refused}")
        print(f"cluster: GET /<fid> on the follower: 301 to the leader, "
              f"then to a holder; a POST to A without a token and one with "
              f"another fid's token: {refused}")

        # the backup tool: a full copy now, the tail after the deletes
        t0 = time.perf_counter()
        full = volume_tools.backup_volume(murl, vid, bk_dir,
                                          CLUSTER_COLLECTION)
        backup_full_s = time.perf_counter() - t0
        if full["mode"] != "full" or full["applied"] != len(plan):
            raise AssertionError(f"full backup: {full}")
        numbers.update(backup_full_s=round(backup_full_s, 3),
                       backup_full_bytes=full["size"])
        print(f"cluster: backup (full) of volume {vid}: {full['size']} B "
              f"pulled, {len(plan)} records indexed, in "
              f"{backup_full_s:.2f} s "
              f"({full['size'] / backup_full_s / 1e6:.1f} MB/s)")

        deleted = fids[::10]
        for fid in deleted:
            if not op.delete_file(murl, fid, jwt=GenJwt(jwt_key, fid)):
                raise AssertionError(f"DELETE {fid} refused")
            want.pop(fid)
        for name in ("A", "B"):
            _gone(urls[name], deleted)
        live = [fid for fid in fids if fid in want]
        print(f"cluster: {len(deleted)} needles deleted through the "
              f"client, each with its token, 404 on A and on B")

        t0 = time.perf_counter()
        inc = volume_tools.backup_volume(murl, vid, bk_dir,
                                         CLUSTER_COLLECTION)
        backup_inc_s = time.perf_counter() - t0
        inc_bytes = inc["size"] - full["size"]
        tombstones = len(deleted) * get_actual_size(0, CURRENT_VERSION)
        if inc["mode"] != "incremental" or \
                inc["applied"] != len(deleted) or inc_bytes != tombstones:
            raise AssertionError(f"incremental backup: {inc}, "
                                 f"{inc_bytes} B for {tombstones} B of "
                                 f"tombstones")
        bk = Volume(bk_dir, CLUSTER_COLLECTION, vid)
        try:
            for fid in fids:
                _, key, cookie = parse_file_id(fid)
                try:
                    got = bk.read_needle(Needle(id=key, cookie=cookie))
                except NotFound:
                    got = None
                if (got is None) != (fid not in want) or got is not None \
                        and hashlib.sha256(got.data).hexdigest() != \
                        want[fid][0]:
                    raise AssertionError(f"backup: needle {fid} differs")
        finally:
            bk.close()
        numbers.update(backup_inc_s=round(backup_inc_s, 3),
                       backup_inc_bytes=inc_bytes)
        print(f"cluster: backup (incremental) of volume {vid}: "
              f"{inc['applied']} tombstone records, {inc_bytes} B, in "
              f"{backup_inc_s:.3f} s; every live needle of the backup "
              f"sha256-identical, every deleted one gone")

        # volume.vacuum below the deleted share: exactly the deleted
        # needles' records and their tombstones go, on both replicas
        gone_keys = {parse_file_id(fid)[1] for fid in deleted}
        dats = {n: dat_path(n, vid) for n in ("A", "B")}
        before, reclaim = {}, {}
        for name, path in dats.items():
            before[name] = os.path.getsize(path)
            with open(path, "rb") as f:
                def pread(off, size, f=f):
                    f.seek(off)
                    return f.read(size)
                reclaim[name] = sum(
                    actual for n, _, actual in volume_backup.walk_records(
                        pread, CURRENT_VERSION, 8, before[name])
                    if n.id in gone_keys)
        a.heartbeat_once()
        _wait_for("the deletes in the master's view", lambda: all(
            r["deleted_byte_count"] > 0 for r in replica_info(vid).values()),
            10.0)
        share = min(r["deleted_byte_count"] / r["size"]
                    for r in replica_info(vid).values())
        t0 = time.perf_counter()
        out = _shell(murl, f"volume.vacuum -garbageThreshold "
                           f"{share / 2:.6f}")
        vacuum_s = time.perf_counter() - t0
        if f"volume {vid}: vacuumed" not in out:
            raise AssertionError(f"volume.vacuum: {out}")
        a.heartbeat_once()
        _wait_for("no deleted bytes in the master's view", lambda: all(
            r["deleted_byte_count"] == 0 for r in replica_info(vid).values()),
            10.0)
        after = {name: os.path.getsize(path) for name, path in dats.items()}
        for name in dats:
            if before[name] - after[name] != reclaim[name]:
                raise AssertionError(
                    f"vacuum on {name}: {before[name]} -> {after[name]} "
                    f"B, the deleted records are {reclaim[name]} B")
        for name in ("A", "B"):
            _timed_gets(urls[name], live, want, CLUSTER_THREADS)
            _gone(urls[name], deleted)
        numbers.update(vacuum_s=round(vacuum_s, 3),
                       vacuum_reclaimed_bytes=reclaim["A"],
                       pre_vacuum_dat_bytes=before["A"])
        print(f"cluster: volume.vacuum {vacuum_s:.2f} s: {reclaim['A']} B "
              f"reclaimed on A and {reclaim['B']} B on B (the deleted "
              f"needles' records and their tombstones), no deleted bytes "
              f"left in the master's view; every live needle GET back "
              f"sha256-identical from A and B, every deleted one 404")
        live_bytes = sum(e[5] for e, fid in zip(plan, fids) if fid in want)
        fsck_s = fsck_deep(["A", "B"])
        numbers.update(fsck_deep_s=round(fsck_s, 3),
                       fsck_deep_mb_s=round(2 * live_bytes / fsck_s / 1e6,
                                            1))
        print(f"cluster: volume.fsck -deep {fsck_s:.2f} s "
              f"({numbers['fsck_deep_mb_s']} MB/s of live needles): "
              f"checked={len(live)} errors=0 on A and on B")
        procs.wait_listening(["C", "D"])
        urls.update(C=procs.urls["C"], D=procs.urls["D"])
        name_of = {u: n for n, u in urls.items()}
        _wait_for("C and D registered", lambda: nodes() == set(
            urls.values()), HOLDER_START_S)
        print(f"cluster: C {urls['C']}, D {urls['D']} "
              f"({CLUSTER_SLOTS['C']} slots each, processes) registered")

        # volume.move B -> C: from here C is the second replica
        t0 = time.perf_counter()
        _shell(murl, f"volume.move -volumeId {vid} -source {urls['B']} "
                     f"-target {urls['C']}")
        move_s = time.perf_counter() - t0
        holders = sorted(op.lookup(murl, vid))
        left_on_b = [f for f in os.listdir(procs.dirs["B"])
                     if f.startswith(f"{CLUSTER_COLLECTION}_{vid}.")]
        if holders != sorted([urls["A"], urls["C"]]) or left_on_b:
            raise AssertionError(f"volume.move: /dir/lookup {holders}, "
                                 f"left on B {left_on_b}")
        _timed_gets(urls["C"], live, want, CLUSTER_THREADS)
        moved = os.path.getsize(dat_path("C", vid))
        numbers.update(move_s=round(move_s, 3),
                       move_mb_s=round(moved / move_s / 1e6, 1))
        print(f"cluster: volume.move B -> C {move_s:.2f} s "
              f"({numbers['move_mb_s']} MB/s of .dat): /dir/lookup lists A "
              f"and C, no file of volume {vid} left on B; every live "
              f"needle GET back sha256-identical from C")

        # ec.encode on A; A's frozen, compacted .dat is the reference
        for name in ("A", "C"):
            _post(urls[name], f"/admin/volume/readonly?volume={vid}")
        os.makedirs(ref_dir)
        base_a = a.store.find_volume(vid).file_name()
        ref_base = os.path.join(ref_dir, os.path.basename(base_a))
        for ext in (".dat", ".idx"):
            _link(base_a + ext, ref_base + ext)
        t0 = time.perf_counter()
        out = counted("encode", lambda: _shell(
            murl, f"ec.encode -volumeId {vid}"))
        encode_s = time.perf_counter() - t0
        if f"streamed 14 shards from {urls['A']}" not in out or \
                "ec encoded, original removed" not in out:
            raise AssertionError(f"ec.encode did not stream from A: {out}")
        counted("reference encode", lambda: ec.write_ec_files(
            ref_base, codec=_plain_card_codec(np, ec)))
        if launched["reference encode"] != (0, 0):
            raise AssertionError(f"the reference encode launched K1: "
                                 f"{launched['reference encode']}")
        shas = _shas([ref_base + ec.to_ext(s)
                      for s in range(ec.TOTAL_SHARDS)])
        dat_size = os.path.getsize(ref_base + ".dat")
        shard_size = os.path.getsize(ref_base + ec.to_ext(0))
        dirs = dict(procs.dirs, A=d_a)

        def check_shards(label, placed):
            for sid in range(ec.TOTAL_SHARDS):
                if len(placed.get(sid, [])) != 1:
                    raise AssertionError(f"{label}: shard {sid} held by "
                                         f"{placed.get(sid)}")
                path = os.path.join(dirs[name_of[placed[sid][0]]],
                                    os.path.basename(base_a)
                                    + ec.to_ext(sid))
                if _sha(path) != shas[sid]:
                    raise AssertionError(f"{label}: shard {sid} differs")
            return {n: sorted(s for s, u in placed.items()
                              if u[0] == urls[n]) for n in urls}

        placed = ec_shards(vid)
        by_name = check_shards("encode", placed)
        gone_replicas = str(vid) in get_json(
            f"http://{murl}/cluster/volumes")["volumes"] or \
            a.store.find_volume(vid) is not None or os.path.exists(
                os.path.join(dirs["C"], os.path.basename(base_a) + ".dat"))
        n_slabs = launched["encode"][0]
        if gone_replicas or launched["encode"][1] != n_slabs or n_slabs < 1:
            raise AssertionError(f"encode: original left {gone_replicas}, "
                                 f"launches, dispatches "
                                 f"{launched['encode']}")
        numbers.update(encode_s=round(encode_s, 3), dat_bytes=dat_size,
                       encode_mb_s=round(dat_size / encode_s / 1e6, 1),
                       shard_size=shard_size, placement=by_name)
        print(f"cluster: ec.encode {encode_s:.2f} s "
              f"({numbers['encode_mb_s']} MB/s of .dat) from A: shards "
              f"{by_name}, each sha256-identical to a local encode of A's "
              f"frozen, compacted .dat; the volume gone from A and C; "
              f"{n_slabs} K1 launches on A = the encode's dispatches")
        print(f"cluster: the encoded .dat {dat_size} B, "
              f"{numbers['pre_vacuum_dat_bytes']} B before the vacuum")

        # the holder of the most shards dies
        victim = max(("B", "C", "D"), key=lambda n: (len(by_name[n]),
                                                     n == "B"))
        lost = by_name[victim]
        procs.kill(victim)
        t0 = time.perf_counter()
        prune_s = _wait_for(
            f"the master prunes {victim}",
            lambda: urls[victim] not in nodes() and not set(lost)
            & set(ec_shards(vid)), PRUNE_WAIT_S)
        ev = a.store.find_ec_volume(vid)
        touching = [fid for fid in live if any(
            iv.to_shard_id_and_offset(ec.LARGE_BLOCK_SIZE,
                                      ec.SMALL_BLOCK_SIZE)[0] in lost
            for iv in ev.locate_needle(parse_file_id(fid)[1])[2])]
        eng0 = a.degraded.snapshot()
        deg_s, deg_bytes, lat = counted(
            "degraded", lambda: _timed_gets(urls["A"], touching, want))
        eng = a.degraded.snapshot()
        dev_disp = eng["device_dispatches"] - eng0["device_dispatches"]
        if launched["degraded"] != (dev_disp, dev_disp) or dev_disp < 1 or \
                eng["errors"] != eng0["errors"]:
            raise AssertionError(f"degraded GETs: launches, dispatches "
                                 f"{launched['degraded']}, engine {eng}")
        numbers.update(
            victim=victim, lost=lost, prune_s=round(prune_s, 3),
            degraded_gets=len(touching),
            degraded_p50_ms=round(_pct(lat, 0.5), 3),
            degraded_p99_ms=round(_pct(lat, 0.99), 3),
            degraded_mb_s=round(deg_bytes / deg_s / 1e6, 1),
            degraded_device_dispatches=dev_disp,
            degraded_host_dispatches=eng["host_dispatches"]
            - eng0["host_dispatches"])
        print(f"cluster: {victim} (shards {lost}) killed; pruned by the "
              f"master in {prune_s:.2f} s; {len(touching)} needle GETs "
              f"through its shards from A, {DEGRADED_THREADS} threads, in "
              f"{deg_s:.2f} s: p50 {numbers['degraded_p50_ms']} ms, p99 "
              f"{numbers['degraded_p99_ms']} ms, "
              f"{numbers['degraded_mb_s']} MB/s; {dev_disp} K1 launches = "
              f"A's device dispatches")

        # the leader stops, with no hand-off; the survivors elect another,
        # the servers register with it and its shard map is the old one's
        listed = ec_shards(vid)
        old_max_vid = leader.topology.max_volume_id
        leader.stop()
        live_masters.remove(leader)
        failover_s = _wait_for("a new raft leader",
                               lambda: _raft_leader(live_masters),
                               ELECTION_WAIT_S)
        new_leader = _raft_leader(live_masters)
        for m in live_masters:
            st = get_json(f"http://{m.url}/cluster/status")
            named = sorted(u.url for u in masters if u is not new_leader)
            if not st["isLeader"] or st["leader"] != new_leader.url or \
                    sorted(st["peers"]) != named:
                raise AssertionError(f"/cluster/status of {m.url}: {st}")
        alive = [n for n in urls if n != victim]
        register_s = _wait_for(
            "the servers registered with the new leader",
            lambda: nodes() == {urls[n] for n in alive}, PRUNE_WAIT_S)
        ec_status_s = _wait_for(
            "the new leader's shard map", lambda: ec_shards(vid) == listed,
            PRUNE_WAIT_S)
        if any(urls[victim] in holders for holders in listed.values()):
            raise AssertionError(f"{victim} in the shard map: {listed}")
        # no file key or volume id is issued again
        grown = post_json(f"http://{murl}/vol/grow?collection="
                          f"{CLUSTER_COLLECTION}-ids&count=1")
        new_vids = [int(v) for v, reps in get_json(
            f"http://{murl}/cluster/volumes")["volumes"].items()
            if reps[0]["collection"] == f"{CLUSTER_COLLECTION}-ids"]
        new_keys = [key_of(op.assign(
            murl, collection=f"{CLUSTER_COLLECTION}-ids")["fid"])
            for _ in range(ID_ASSIGNS)]
        if grown != {"count": 1} or len(new_vids) != 1 or \
                min(new_vids) <= old_max_vid or \
                min(new_keys) <= max(issued):
            raise AssertionError(f"ids after the failover: grown {grown}, "
                                 f"volumes {new_vids} (before: up to "
                                 f"{old_max_vid}), keys {new_keys} (before: "
                                 f"up to {max(issued)})")
        numbers.update(
            failover_elect_s=round(failover_s, 3),
            reregister_s=round(register_s, 3),
            ec_status_s=round(ec_status_s, 3),
            key_margin=min(new_keys) - max(issued),
            vid_margin=min(new_vids) - old_max_vid)
        print(f"cluster: leader {leader.url} stopped; {new_leader.url} "
              f"elected in {failover_s:.3f} s, named by both survivors' "
              f"/cluster/status with its peers; the servers registered with "
              f"it {register_s:.3f} s after, its /cluster/ec_status the old "
              f"leader's ({ec_status_s:.3f} s, {victim} absent); "
              f"/vol/grow and {ID_ASSIGNS} assigns through the follower: "
              f"volume {min(new_vids)} (> {old_max_vid}), keys from "
              f"{min(new_keys)} (> {max(issued)})")

        t0 = time.perf_counter()
        out = counted("rebuild", lambda: _shell(murl, "ec.rebuild"))
        rebuild_s = time.perf_counter() - t0
        if f"rebuilt shards {lost} on {urls['A']}" not in out or \
                launched["rebuild"][0] != launched["rebuild"][1] or \
                launched["rebuild"][0] < 1:
            raise AssertionError(f"ec.rebuild: {out}, launches, dispatches "
                                 f"{launched['rebuild']}")
        check_shards("rebuild", ec_shards(vid))
        numbers["trace"] = rebuild_trace(murl, urls, new_leader, victim,
                                         work)
        t0b = time.perf_counter()
        counted("balance", lambda: _shell(murl, "ec.balance"))
        balance_s = time.perf_counter() - t0b
        alive = [n for n in urls if n != victim]
        by_name = {n: shards for n, shards in check_shards(
            "balance", ec_shards(vid)).items() if n in alive}
        t0r = time.perf_counter()
        counted("reads after balance", lambda: [
            _timed_gets(urls[alive[i % len(alive)]],
                        live[i::len(alive)], want, CLUSTER_THREADS)
            for i in range(len(alive))])
        if launched["reads after balance"][0]:
            raise AssertionError(f"reads with all 14 shards live "
                                 f"reconstructed: "
                                 f"{launched['reads after balance']}")
        numbers.update(rebuild_s=round(rebuild_s, 3),
                       balance_s=round(balance_s, 3),
                       balanced=by_name,
                       reads_after_balance_s=round(
                           time.perf_counter() - t0r, 3))
        print(f"cluster: ec.rebuild {rebuild_s:.2f} s on A (shards {lost}, "
              f"{launched['rebuild'][0]} K1 launches = dispatches), "
              f"ec.balance {balance_s:.2f} s: shards {by_name}, all 14 "
              f"mounted and sha256-identical; every live needle read "
              f"through {', '.join(alive)} in turn, no launch on A")

        t0 = time.perf_counter()
        out = counted("decode", lambda: _shell(
            murl, f"ec.decode -volumeId {vid}"))
        decode_s = time.perf_counter() - t0
        target = op.lookup(murl, vid)
        t0r = time.perf_counter()

        def read_back(fid):
            if hashlib.sha256(op.read_file(murl, fid)).hexdigest() != \
                    want[fid][0]:
                raise AssertionError(f"after ec.decode: {fid} differs")

        with ThreadPoolExecutor(CLUSTER_THREADS) as pool:
            list(pool.map(read_back, live))
        if str(vid) in get_json(f"http://{murl}/cluster/ec_status")[
                "volumes"] or len(target) != 1:
            raise AssertionError(f"ec.decode: {out}, lookup {target}")
        numbers.update(decode_s=round(decode_s, 3),
                       decode_target=name_of[target[0]],
                       reads_after_decode_s=round(
                           time.perf_counter() - t0r, 3))
        print(f"cluster: ec.decode {decode_s:.2f} s onto "
              f"{numbers['decode_target']}; every live needle read "
              f"through /dir/lookup sha256-identical; the volume out of "
              f"/cluster/ec_status")

        # the decoded volume's one replica: unmount, mount, re-replicate
        holder = target[0]
        _shell(murl, f"volume.unmount -volumeId {vid} -node {holder}")
        _gone(holder, live[:1])
        _shell(murl, f"volume.mount -volumeId {vid} -node {holder}")
        _timed_gets(holder, live[:1], want)
        t0 = time.perf_counter()
        out = _shell(murl, "volume.fix.replication")
        fix_s = time.perf_counter() - t0
        holders = op.lookup(murl, vid)
        if len(holders) != 2 or "1 copies made" not in out:
            raise AssertionError(f"volume.fix.replication: {out}, "
                                 f"/dir/lookup {holders}")
        copy = next(u for u in holders if u != holder)
        copied = os.path.getsize(dat_path(name_of[holder], vid))
        numbers.update(fix_replication_s=round(fix_s, 3),
                       fix_replication_mb_s=round(copied / fix_s / 1e6, 1),
                       fix_replication_target=name_of[copy])
        fsck2_s = fsck_deep([name_of[holder], name_of[copy]])
        _timed_gets(copy, live, want, CLUSTER_THREADS)
        numbers.update(fsck_deep_after_fix_mb_s=round(
            2 * live_bytes / fsck2_s / 1e6, 1))
        print(f"cluster: volume.unmount and volume.mount on "
              f"{name_of[holder]} (a needle GET back after); "
              f"volume.fix.replication {fix_s:.2f} s "
              f"({numbers['fix_replication_mb_s']} MB/s of .dat) onto "
              f"{name_of[copy]}: /dir/lookup lists both; volume.fsck -deep "
              f"{fsck2_s:.2f} s, 0 errors on both; every live needle GET "
              f"back sha256-identical from {name_of[copy]}")

        # /submit into a second collection, then collection.delete of it
        tmp = CLUSTER_COLLECTION + "-tmp"
        rng = np.random.default_rng(seed + 1)
        submitted = {}
        for i in range(4):
            data = rng.bytes(1000 + 777 * i)
            got = post_multipart(f"http://{murl}/submit?collection={tmp}",
                                 f"submit-{i}.bin", data)
            if got.get("size") != len(data):
                raise AssertionError(f"/submit: {got}")
            submitted[got["fid"]] = data
        for fid, data in submitted.items():
            if op.read_file(murl, fid) != data:
                raise AssertionError(f"/submit: {fid} read back differs")
        tmp_vids = sorted(int(v) for v, reps in get_json(
            f"http://{murl}/cluster/volumes")["volumes"].items()
            if reps[0]["collection"] == tmp)
        out = _shell(murl, "collection.list")
        if f"collection {CLUSTER_COLLECTION!r}" not in out or \
                f"collection {tmp!r}" not in out:
            raise AssertionError(f"collection.list: {out}")
        _shell(murl, f"collection.delete -collection {tmp}")
        alive = [n for n in urls if n != victim]
        for name in alive:
            held = {v["id"] for v in
                    get_json(f"http://{urls[name]}/status")["volumes"]}
            if held & set(tmp_vids):
                raise AssertionError(f"collection.delete: {name} still "
                                     f"serves {held & set(tmp_vids)}")
        for v in tmp_vids:
            try:
                get_json(f"http://{murl}/dir/lookup?volumeId={v}")
            except HttpError as e:
                if e.status == 404:
                    continue
                raise
            raise AssertionError(f"collection.delete: {v} still looked up")
        if sorted(op.lookup(murl, vid)) != sorted(holders):
            raise AssertionError("collection.delete touched the first "
                                 "collection")
        _timed_gets(holder, live[:4], want)
        numbers.update(submitted=len(submitted), tmp_volumes=tmp_vids)
        print(f"cluster: {len(submitted)} needles through /submit into "
              f"{tmp!r} (volumes {tmp_vids}), each read back; "
              f"collection.list shows both collections; collection.delete "
              f"of {tmp!r}: its volumes off every server's /status and out "
              f"of /dir/lookup, {CLUSTER_COLLECTION!r} untouched")
        numbers["forwarded"] = follower.forwarded
    finally:
        procs.stop_processes()
        a.stop()
        for m in live_masters:
            m.stop()
        for d in [d_a, ref_dir, bk_dir, raft_dir] + \
                list(procs.dirs.values()):
            shutil.rmtree(d, ignore_errors=True)
    numbers["launches"] = {name: n for name, (n, _) in launched.items()}
    numbers["leg_s"] = round(time.perf_counter() - leg_t0, 3)
    for stat, label in (("write", "writes"), ("read_A", "reads from A"),
                        ("read_B", "reads from B"),
                        ("read_redirect", "reads by redirect")):
        print(f"cluster {label}: {numbers[stat + '_mb_s']} MB/s"
              + (f", {numbers['write_req_s']} requests/s (001: each "
                 f"fanned out)" if stat == "write" else ""))
    for step in ("encode", "prune", "rebuild", "balance", "decode"):
        print(f"cluster {step} wall: {numbers[step + '_s']} s")
    print(f"cluster raft: elected in {numbers['elect_s']} s, again in "
          f"{numbers['failover_elect_s']} s after the leader stopped; the "
          f"servers registered {numbers['reregister_s']} s after; "
          f"{numbers['forwarded']} requests forwarded through the "
          f"follower; key margin {numbers['key_margin']}, volume-id "
          f"margin {numbers['vid_margin']}")
    print(f"cluster vacuum: {numbers['vacuum_s']} s, "
          f"{numbers['vacuum_reclaimed_bytes']} B reclaimed")
    print(f"cluster fsck -deep: {numbers['fsck_deep_mb_s']} MB/s, "
          f"{numbers['fsck_deep_after_fix_mb_s']} MB/s after "
          f"fix.replication")
    print(f"cluster move: {numbers['move_mb_s']} MB/s; fix.replication: "
          f"{numbers['fix_replication_mb_s']} MB/s")
    print(f"cluster incremental backup: {numbers['backup_inc_bytes']} B "
          f"in {numbers['backup_inc_s']} s (full: "
          f"{numbers['backup_full_bytes']} B in "
          f"{numbers['backup_full_s']} s)")
    print(f"cluster degraded GETs: p50 {numbers['degraded_p50_ms']} ms, "
          f"p99 {numbers['degraded_p99_ms']} ms")
    print(f"cluster K1 launches by step: {json.dumps(numbers['launches'])}")
    print(f"cluster: {json.dumps(numbers)}")
    return numbers


def rebuild_trace(murl, urls, leader, victim, work):
    """Step 14 (b): the ec.rebuild just run through the shell (in this
    process, beside the masters and A) is one trace. Its id is the
    newest trace on A whose root span is the shell's ``ec.rebuild``;
    ``trace.export -trace <id>`` through the port shell merges that
    trace's spans from every node the shell names (this process's ring
    and the processes'): the shell's root (node ``client``), the leader,
    A with at least one ``dispatch`` span, and each peer that served a
    shard read, with no negative ``ts`` or ``dur``. Then
    ``cluster.profile -seconds 0.2``, which must gather stacks from every
    master and server it names. Returns the trace's numbers."""
    from seaweedfs_tpu_torch.server.http_util import get_json
    t0 = time.perf_counter()
    traces = get_json(f"http://{urls['A']}/admin/traces?n=256")["traces"]
    tid = next((t["trace_id"] for t in traces if t["root"] == "ec.rebuild"),
               None)
    if tid is None:
        raise AssertionError("no ec.rebuild trace in A's ring")
    dest = os.path.join(work, "cluster-rebuild-trace.json")
    out = _shell(murl, f"trace.export -trace {tid} -o {dest}")
    if not out.startswith("trace.export: "):
        raise AssertionError(f"trace.export: {out}")
    with open(dest) as f:
        merged = json.load(f)
    events = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    names_by_node = {}
    for e in events:
        names_by_node.setdefault(e["args"]["node"], []).append(e["name"])
    peers = sorted(n for n, names in names_by_node.items()
                   if n not in (urls["A"], "client") and any(
                       "/admin/ec/shard_" in x for x in names))
    dispatches = names_by_node.get(urls["A"], []).count("dispatch")
    if not events or any(e["ts"] < 0 or e["dur"] < 0 for e in events) or \
            any(e["args"]["trace_id"] != tid for e in events) or \
            "ec.rebuild" not in names_by_node.get("client", []) or \
            leader.url not in names_by_node or dispatches < 1 or \
            not peers or urls[victim] in names_by_node:
        raise AssertionError(f"the rebuild's trace {tid}: spans by node "
                             f"{names_by_node}")
    role = {u: n for n, u in urls.items()}
    # the shell's master may be the new leader itself
    role.update({murl: "follower", "client": "shell"})
    role[leader.url] = "leader"

    def named(per_node):
        return {role.get(n, n): v for n, v in sorted(per_node.items())}
    # where the rebuild's time went: span seconds by node and name
    split = {}
    for e in events:
        key = f"{role.get(e['args']['node'], e['args']['node'])} {e['name']}"
        split[key] = round(split.get(key, 0.0) + e["dur"] / 1e6, 6)
    numbers = {"trace_id": tid, "spans": len(events),
               "spans_by_node": named({n: len(v) for n, v in
                                       names_by_node.items()}),
               "dispatch_spans_on_A": dispatches,
               "peers": [role[p] for p in peers],
               "clock_offsets_s": named(
                   merged["metadata"].get("clock_offsets_s", {})),
               "seconds_by_span": dict(sorted(split.items(),
                                              key=lambda kv: -kv[1])),
               "export_s": round(time.perf_counter() - t0, 3)}
    print(f"cluster trace: ec.rebuild {tid}: {len(events)} spans from "
          f"{len(names_by_node)} nodes "
          f"({json.dumps(numbers['spans_by_node'])}), {dispatches} "
          f"dispatch spans on A, shard reads served by {numbers['peers']}; "
          f"clock offsets {json.dumps(numbers['clock_offsets_s'])}")
    print(f"cluster trace seconds by node and span: "
          f"{json.dumps(numbers['seconds_by_span'])}")
    t0 = time.perf_counter()
    dest = os.path.join(work, "cluster-profile.folded")
    out = _shell(murl, f"cluster.profile -seconds 0.2 -o {dest}")
    targets = 1 + len([u for u in urls.values() if u != urls[victim]])
    if f"from {targets}/{targets} nodes" not in out:
        raise AssertionError(f"cluster.profile: {out}")
    with open(dest) as f:
        numbers["profile_stacks"] = sum(1 for _ in f)
    numbers["profile_s"] = round(time.perf_counter() - t0, 3)
    return numbers


def _devices_k1(url):
    """K1's launches on the card of the server at ``url``, from its
    /admin/devices."""
    from seaweedfs_tpu_torch.ops.device_stats import K1
    from seaweedfs_tpu_torch.server.http_util import get_json
    return get_json(f"http://{url}/admin/devices")["stats"][
        "launches"].get(K1, 0)


def integrity_servers(work, seed):
    """Step 15's master (a repair loop every INTEGRITY_REPAIR_S, its
    drain held while the returned gate is clear) and its B and C
    processes, spawned and not waited for: started before the legs that
    precede step 15, so their start-up overlaps those legs. Returns
    (master, drain gate, processes)."""
    from seaweedfs_tpu_torch.server.master import MasterServer
    master = MasterServer(port=0, pulse_seconds=CLUSTER_PULSE_S, seed=seed,
                          repair_interval=INTEGRITY_REPAIR_S).start()
    drain_gate = threading.Event()
    drain_gate.set()
    drain_one = master._drain_one

    def gated_drain(inc):
        drain_gate.wait()
        return drain_one(inc)

    master._drain_one = gated_drain
    procs = VolumeProcesses(work, master.url, slots=INTEGRITY_SLOTS,
                            prefix="integrity",
                            args=("--scrub-rate-mbps", "0",
                                  "--device", SERVER_DEVICE))
    procs.spawn_all(["B", "C"])
    return master, drain_gate, procs


def integrity_leg(np, port, work, base, res, seed, servers):
    """Step 15: scrub findings, the master's repair queue and its drain
    onto K1 on the holder, held by each server's /admin/devices, on the
    master and processes of ``servers`` (integrity_servers). Returns the
    leg's numbers; stops every process and removes its directories in a
    finally."""
    ec, _, _ = port
    from seaweedfs_tpu_torch.server.http_util import (get_json, http_call,
                                                      post_json)
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
    from seaweedfs_tpu_torch.storage.types import entry_size, format_file_id
    rng = np.random.default_rng(seed)
    from seaweedfs_tpu_torch.ec.gather import auto_slab
    from seaweedfs_tpu_torch.ops import telemetry
    vid, total = 1, ec.TOTAL_SHARDS
    # a repair's stripes at the slab a rebuild picks when not told
    stripes = -(-res["shard_size"] // auto_slab(res["shard_size"]))
    numbers, walls = {}, {}
    leg_t0 = time.perf_counter()
    step_t0 = [leg_t0]

    def step(name):
        walls[name] = round(time.perf_counter() - step_t0[0], 3)
        print(f"integrity step {name}: {walls[name]} s")
        step_t0[0] = time.perf_counter()

    master, drain_gate, procs = servers
    murl = master.url
    d_a = os.path.join(work, "integrity-A")
    os.makedirs(d_a)
    for ext in (".dat", ".idx"):
        _link(base + ext, os.path.join(d_a, f"{vid}{ext}"))
    a = VolumeServer(port=0, directories=[d_a], device=SERVER_DEVICE,
                     master_url=murl, pulse_seconds=CLUSTER_PULSE_S,
                     max_volume_counts=[INTEGRITY_SLOTS["A"]],
                     scrub_idle_s=0, scrub_rate_mbps=0, fast_port=-1).start()
    naive = None
    d_n = os.path.join(work, "integrity-naive")

    def repairs():
        return get_json(f"http://{murl}/cluster/repairs")

    def incidents(kind):
        view = repairs()
        return [i for i in view["open"] + view["resolved_recent"]
                if i["kind"] == kind and i["volume"] == vid]

    def ec_shards():
        vols = get_json(f"http://{murl}/cluster/ec_status")["volumes"]
        return {int(s): urls for s, urls in
                vols.get(str(vid), {}).get("shards", {}).items()}

    def shard_path(name, sid):
        return os.path.join(dirs[name], f"{vid}{ec.to_ext(sid)}")

    try:
        procs.wait_listening(["B", "C"])
        urls = {"A": a.url, "B": procs.urls["B"], "C": procs.urls["C"]}
        name_of = {u: n for n, u in urls.items()}
        dirs = dict(procs.dirs, A=d_a)
        _wait_for("A, B and C registered", lambda: {
            n["url"] for n in get_json(f"http://{murl}/cluster/status")[
                "nodes"]} == set(urls.values()), HOLDER_START_S)
        step("start")

        numbers["launches"] = {n: {} for n in urls}
        k1, before = _k1(), telemetry.STATS.snapshot()
        out = _shell(murl, f"ec.encode -volumeId {vid}")
        k1 = numbers["launches"]["A"]["ec.encode"] = _k1() - k1
        disp = telemetry.delta(before)["dispatches"]
        if f"streamed 14 shards from {urls['A']}" not in out or \
                k1 != disp or k1 < 1:
            raise AssertionError(f"ec.encode did not stream from A on K1 "
                                 f"({k1} launches for {disp} dispatches): "
                                 f"{out}")
        _wait_for("14 shards registered", lambda: len(ec_shards()) == total,
                  INTEGRITY_WAIT_S)
        placed = {n: sorted(s for s, u in ec_shards().items()
                            if u == [urls[n]]) for n in urls}
        if sorted(sum(placed.values(), [])) != list(range(total)) or \
                0 not in placed["B"]:
            raise AssertionError(f"ec.encode placement {placed}")
        numbers["placement"] = placed
        step("ec.encode")

        # a clean scrub of the whole stripe on every server
        before = {n: (_devices_k1(u), get_json(
            f"http://{u}/admin/ec/scrub_status")) for n, u in urls.items()}
        out = _shell(murl, "volume.ec.scrub -trigger")
        numbers["scrub_mb_s"] = {}
        for n, u in urls.items():
            snap = get_json(f"http://{u}/admin/ec/scrub_status")
            k1 = _devices_k1(u) - before[n][0]
            dev = snap["device_dispatches"] - before[n][1][
                "device_dispatches"]
            if snap["findings"] or snap["corrupt_slabs"] or \
                    snap["volumes_scrubbed"] != 1 or k1 != dev or k1 < 1:
                raise AssertionError(f"clean scrub on {n}: {snap}, {k1} K1 "
                                     f"launches for {dev} device dispatches")
            numbers["scrub_mb_s"][n] = snap["last_pass_mbps"]
            numbers["launches"][n]["clean scrub"] = k1
        # at-risk-holder advisories are no incident of this check: the
        # health fold may open them on a loaded host, and A's board (the
        # process's) still scores the earlier legs' holders
        if [i for i in repairs()["open"] if i["kind"] != "at_risk_holder"]:
            raise AssertionError(f"incidents after a clean scrub: "
                                 f"{repairs()}")
        step("clean scrub")

        # corruption: a byte of a shard of B's, found, drained, repaired
        sid = int(rng.choice([s for s in placed["B"] if s != 0]))
        off = int(rng.integers(res["shard_size"] // 4,
                               3 * res["shard_size"] // 4))
        path = shard_path("B", sid)
        _flip_byte(path, off)
        # the drain waits until B's scrub launches are read, so scrub and
        # repair are each a measured delta of B's K1 launches
        drain_gate.clear()
        k1_b = _devices_k1(urls["B"])
        dev_b = get_json(f"http://{urls['B']}/admin/ec/scrub_status")[
            "device_dispatches"]
        found = post_json(f"http://{urls['B']}/admin/ec/scrub?volume={vid}",
                          timeout=300)
        if found["clean"] or found["corrupt_shards"] != [sid] or \
                found["corrupt_slabs"] != [off // SCRUB_N]:
            raise AssertionError(f"B's scrub of shard {sid} byte {off}: "
                                 f"{found}")
        scrub_k1 = _devices_k1(urls["B"]) - k1_b
        dev = get_json(f"http://{urls['B']}/admin/ec/scrub_status")[
            "device_dispatches"] - dev_b
        if scrub_k1 != dev or scrub_k1 < 1:
            raise AssertionError(f"B's finding scrub: {scrub_k1} K1 launches "
                                 f"for {dev} device dispatches")
        k1_b += scrub_k1
        drain_gate.set()
        _wait_for("the corruption incident", lambda: incidents(
            "corruption"), INTEGRITY_WAIT_S)
        got = incidents("corruption")
        if len(got) != 1 or got[0]["priority"] != 0 or \
                got[0]["shard"] != sid:
            raise AssertionError(f"corruption incidents {got}")
        _wait_for("the corruption repaired", lambda: incidents(
            "corruption")[0]["status"] == "resolved", INTEGRITY_WAIT_S)
        inc = incidents("corruption")[0]
        repair_k1 = _devices_k1(urls["B"]) - k1_b
        if inc["via"] != "scrub_repair" or _sha(path) != res["shas"][sid] \
                or repair_k1 != stripes or ec_shards()[sid] != [urls["B"]]:
            raise AssertionError(f"scrub_repair of {sid}: {inc}, "
                                 f"{repair_k1} K1 launches on B for "
                                 f"{stripes} stripes")
        numbers["corruption"] = {"shard": sid, "byte": off,
                                 "ttr_s": inc["time_to_re_protection_s"]}
        numbers["launches"]["B"].update(scrub=scrub_k1,
                                        scrub_repair=repair_k1)
        step("corruption found and repaired")
        k1_b = _devices_k1(urls["B"])
        again = post_json(f"http://{urls['B']}/admin/ec/scrub?volume={vid}",
                          timeout=300)
        if not again["clean"]:
            raise AssertionError(f"B's second scrub: {again}")
        numbers["launches"]["B"]["second scrub"] = \
            _devices_k1(urls["B"]) - k1_b
        step("second scrub")

        # a lost shard of C's, found by the scan, rebuilt by the drain
        lost = int(rng.choice(placed["C"]))
        k1_b = _devices_k1(urls["B"])
        post_json(f"http://{urls['C']}/admin/ec/delete_shards?volume={vid}"
                  f"&shards={lost}")
        _wait_for("the lost shard rebuilt", lambda: [
            i for i in incidents("lost_shard")
            if i["shard"] == lost and i["status"] == "resolved"],
            INTEGRITY_WAIT_S)
        inc = next(i for i in incidents("lost_shard") if i["shard"] == lost)
        rebuild_k1 = _devices_k1(urls["B"]) - k1_b
        target = ec_shards()[lost]
        if inc["via"] != "rebuild" or target != [urls["B"]] or \
                _sha(shard_path("B", lost)) != res["shas"][lost] or \
                rebuild_k1 != stripes:
            raise AssertionError(f"lost shard {lost}: {inc}, now on "
                                 f"{target}, {rebuild_k1} K1 launches on B "
                                 f"for {stripes} stripes")
        numbers["lost_shard"] = {"shard": lost, "rebuilt_on": "B",
                                 "ttr_s": inc["time_to_re_protection_s"]}
        numbers["launches"]["B"]["rebuild"] = rebuild_k1
        step("lost shard rebuilt")

        # naive degraded reads on a server of its own, through a shard
        # it lacks
        miss = int(rng.integers(0, ec.DATA_SHARDS))
        os.makedirs(d_n)
        for sid_, urls_ in ec_shards().items():
            if sid_ != miss:
                src = shard_path(name_of[urls_[0]], sid_)
                _link(src, os.path.join(d_n, os.path.basename(src)))
        for ext in (".ecx", ".vif"):
            if os.path.exists(os.path.join(d_a, f"{vid}{ext}")):
                _link(os.path.join(d_a, f"{vid}{ext}"),
                      os.path.join(d_n, f"{vid}{ext}"))
        naive = VolumeServer(port=0, directories=[d_n],
                             device=SERVER_DEVICE, scrub_idle_s=0,
                             degraded_mode="naive", fast_port=-1).start()
        ev = naive.store.find_ec_volume(vid)
        rec = entry_size()
        with open(os.path.join(d_n, f"{vid}.ecx"), "rb") as f:
            ecx = f.read()
        nids = [int.from_bytes(ecx[i:i + 8], "big")
                for i in range(0, len(ecx) // rec * rec, rec)]

        def ranges(nid):
            return sum(iv.to_shard_id_and_offset(
                ec.LARGE_BLOCK_SIZE, ec.SMALL_BLOCK_SIZE)[0] == miss
                for iv in ev.locate_needle(nid)[2])

        touching = [nid for nid in nids if ranges(nid)]
        picks = [touching[i] for i in
                 rng.permutation(len(touching))[:INTEGRITY_GETS]]

        def get(nid):
            o, size, _ = ev.locate_needle(nid)
            with open(base + ".dat", "rb") as f:
                f.seek(o)
                want = Needle.from_bytes(
                    f.read(get_actual_size(size, ev.version)), ev.version)
            fid = format_file_id(vid, nid, want.cookie)
            t0 = time.perf_counter()
            body = http_call("GET", f"http://{naive.url}/{fid}",
                             timeout=120)
            secs = time.perf_counter() - t0
            if body != want.data:
                raise AssertionError(f"naive GET {fid} differs from the "
                                     f"needle in the .dat")
            return secs * 1e3

        k1 = _k1()
        with ThreadPoolExecutor(DEGRADED_THREADS) as pool:
            lat = list(pool.map(get, picks))
        naive_k1 = _k1() - k1
        want = sum(ranges(nid) for nid in picks)
        if not picks or naive_k1 != want or \
                naive.degraded.snapshot()["reads"]:
            raise AssertionError(f"naive GETs: {len(picks)}, {naive_k1} K1 "
                                 f"launches for {want} ranges")
        numbers["naive"] = {"lost": miss, "gets": len(picks),
                            "p50_ms": round(_pct(lat, 0.5), 3),
                            "p99_ms": round(_pct(lat, 0.99), 3),
                            "launches": naive_k1}
        step("naive degraded GETs")

        _shell(murl, "cluster.repairs")
        _shell(murl, "cluster.devices")
        view = repairs()
        # at-risk-holder advisories (the health fold) may open on a loaded
        # host: printed, never drained, and no part of these checks
        advisories = [i for i in view["open"] + view["resolved_recent"]
                      if i["kind"] == "at_risk_holder"]
        durable = [i for i in view["resolved_recent"]
                   if i["kind"] != "at_risk_holder"]
        if [i for i in view["open"] if i["kind"] != "at_risk_holder"] or \
                len(durable) != 2:
            raise AssertionError(f"the repair queue at the end: {view}")
        numbers["at_risk_advisories"] = [
            {"holder": i["holder"], "status": i["status"],
             "score": (i.get("detail") or {}).get("score")}
            for i in advisories]
        print(f"integrity: at-risk-holder advisories (advisory only): "
              f"{json.dumps(numbers['at_risk_advisories'])}")
        step("cluster.repairs and cluster.devices")
        numbers["fleet"] = fleet_scrape(murl, urls, durable)
        step("fleet scrape")
    finally:
        drain_gate.set()
        master.stop()
        procs.stop_processes()
        a.stop()
        if naive is not None:
            naive.stop()
        for d in [d_a, d_n] + list(procs.dirs.values()):
            shutil.rmtree(d, ignore_errors=True)
    numbers["walls"] = walls
    numbers["leg_s"] = round(time.perf_counter() - leg_t0, 3)
    print(f"integrity scrub MB/s by server: "
          f"{json.dumps(numbers['scrub_mb_s'])}")
    print(f"integrity detect-to-resolve: corruption "
          f"{numbers['corruption']['ttr_s']} s, lost shard "
          f"{numbers['lost_shard']['ttr_s']} s")
    print(f"integrity K1 launches by server: "
          f"{json.dumps(numbers['launches'])}, naive GETs "
          f"{numbers['naive']['launches']}")
    print(f"integrity: {json.dumps(numbers)}")
    return numbers


def fleet_scrape(murl, urls, durable):
    """Step 15 (c), after both incidents resolved: each server's
    /metrics parses with the port's parse_prometheus_text, and its K1
    dispatch series (SeaweedFS_volumeServer_ec_xla_dispatches_total
    {entry="rs_hopper.gf_matmul"}) equals the K1 dispatches of its
    /admin/devices, read before and after, which equal its launches; the
    master's /cluster/metrics?refresh=1 series is their sum;
    /cluster/health?refresh=1 lists every server fresh, and its repairs
    fold carries the two resolved incidents with /cluster/repairs' times
    to re-protection. Returns the numbers."""
    from seaweedfs_tpu_torch.ops.device_stats import K1
    from seaweedfs_tpu_torch.server.http_util import get_json, http_call
    from seaweedfs_tpu_torch.stats.metrics import parse_prometheus_text
    name_of = {u: n for n, u in urls.items()}

    def k1_series(text):
        fams = parse_prometheus_text(text)
        fam = next(f for f in fams if f["name"] ==
                   "SeaweedFS_volumeServer_ec_xla_dispatches_total")
        (value,) = [v for _, labels, v in fam["samples"]
                    if dict(labels) == {"entry": K1}]
        return value, len(fams)

    t0 = time.perf_counter()
    per = {}
    for name, url in sorted(urls.items()):
        before = get_json(f"http://{url}/admin/devices")["stats"]
        value, fams = k1_series(http_call(
            "GET", f"http://{url}/metrics").decode())
        after = get_json(f"http://{url}/admin/devices")["stats"]
        if not before["dispatches"][K1] == after["dispatches"][K1] == \
                after["launches"][K1] == value or value < 1:
            raise AssertionError(f"{name}'s /metrics K1 series {value}, "
                                 f"/admin/devices {before} then {after}")
        per[name] = {"k1": int(value), "families": fams}
    merged_text = http_call(
        "GET", f"http://{murl}/cluster/metrics?refresh=1").decode()
    merged, _ = k1_series(merged_text)
    # the fleet's EC phase seconds and request seconds, summed by the
    # master over the servers
    split = {}
    for fam in parse_prometheus_text(merged_text):
        if fam["name"] == "SeaweedFS_volumeServer_ec_phase_seconds_total":
            split["phases"] = {dict(lab)["phase"]: round(v, 6)
                               for _, lab, v in fam["samples"]}
        elif fam["name"] == "SeaweedFS_volumeServer_request_seconds":
            split["requests"] = dict(sorted(
                ((dict(lab)["type"], round(v, 6))
                 for name, lab, v in fam["samples"]
                 if name.endswith("_sum")), key=lambda kv: -kv[1])[:8])
    if merged != sum(p["k1"] for p in per.values()):
        raise AssertionError(f"/cluster/metrics K1 series {merged}, the "
                             f"servers' {per}")
    # the repair loop may move an at-risk advisory between two reads:
    # the fold is read between two equal views of the queue
    for _ in range(3):
        ttr = get_json(f"http://{murl}/cluster/repairs")[
            "time_to_re_protection"]
        health = get_json(f"http://{murl}/cluster/health?refresh=1")
        if get_json(f"http://{murl}/cluster/repairs")[
                "time_to_re_protection"] == ttr:
            break
    fresh = sorted(n["node"] for n in health["nodes"] if not n["stale"])
    if fresh != sorted(urls.values()) or \
            health["repairs"]["time_to_re_protection"] != ttr or \
            ttr["count"] < 2 or ttr["max_s"] < max(
                i["time_to_re_protection_s"] for i in durable):
        raise AssertionError(f"/cluster/health: {health}, /cluster/repairs "
                             f"ttr {ttr}")
    numbers = {"k1_by_server": {n: p["k1"] for n, p in per.items()},
               "families_by_server": {n: p["families"]
                                      for n, p in per.items()},
               "k1_merged": int(merged),
               "holders_scored": len(health["holders"]),
               "scores": {name_of.get(h, h): v["score"]
                          for h, v in sorted(health["holders"].items())},
               "ttr": ttr, "fleet_seconds": split,
               "scrape_s": round(time.perf_counter() - t0, 3)}
    print(f"integrity fleet: every /metrics parsed; K1 dispatch series by "
          f"server {json.dumps(numbers['k1_by_server'])} = each one's "
          f"/admin/devices dispatches = its launches; /cluster/metrics "
          f"{int(merged)} = their sum; /cluster/health: {len(fresh)} "
          f"servers fresh, holder scores {json.dumps(numbers['scores'])}, "
          f"repairs ttr {json.dumps(ttr)}")
    print(f"integrity fleet seconds (summed over the servers, whole "
          f"process lives): {json.dumps(split)}")
    return numbers


def _fg_load(np, run, murl, payloads, seed, note):
    """``run()`` in this thread under the foreground load: TIER_READERS
    threads GET the sealed volume's needles through the master's lookup
    (client/operation.read_file: each location in turn) and TIER_WRITERS
    threads upload TIER_WRITE-byte needles into the default collection.
    Returns (run's result, read seconds, read failures, write seconds,
    write failures, the writers' fids)."""
    from seaweedfs_tpu_torch.client import operation as op
    stop = threading.Event()
    lock = threading.Lock()
    reads, rfail, writes, wfail, fids = [], [], [], [], []
    names = sorted(payloads)

    def reader(tid):
        i = tid
        while not stop.is_set():
            fid = names[i % len(names)]
            i += 1
            t0 = time.perf_counter()
            try:
                got = op.read_file(murl, fid)
            except Exception as e:  # noqa: BLE001 - counted, then fails
                with lock:
                    rfail.append(f"{note} GET {fid}: {e!r}")
                continue
            with lock:
                reads.append(time.perf_counter() - t0)
                if got != payloads[fid]:
                    rfail.append(f"{note} GET {fid}: bytes differ")

    def writer(tid):
        rng = np.random.default_rng(seed + 1000 * tid)
        n = 0
        while not stop.is_set():
            data = rng.bytes(TIER_WRITE)
            n += 1
            t0 = time.perf_counter()
            try:
                fid = op.upload_data(murl, data, filename=f"w{tid}-{n}")
            except Exception as e:  # noqa: BLE001 - counted, then fails
                with lock:
                    wfail.append(f"{note} write: {e!r}")
                continue
            with lock:
                writes.append(time.perf_counter() - t0)
                fids.append(fid)

    threads = [threading.Thread(target=reader, args=(t,), daemon=True)
               for t in range(TIER_READERS)]
    threads += [threading.Thread(target=writer, args=(t,), daemon=True)
                for t in range(TIER_WRITERS)]
    for t in threads:
        t.start()
    try:
        out = run()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIER_WAIT_S)
    return out, reads, rfail, writes, wfail, fids


def tiering_leg(np, port, work, seed):
    """The f4 hot→warm lifecycle on a port cluster on 127.0.0.1: an
    in-process MasterServer (no repair or vacuum loop; its tierer at
    TIER_RATE_MBPS, age 0) and TIER_SERVERS in-process VolumeServers on
    the card.

    (a) The remote tier: a 000 volume of TIER_DIR_NEEDLES seeded needles
    (TIER_NEEDLE each) in its own collection, ``volume.tier.upload -dest
    dir.cold`` through the port shell onto a ``dir`` backend of this host
    (the .dat gone, the object byte-equal to it); every needle GET through
    the master, served by the RemoteFile's range reads, equals its write;
    a cold DiskLocation over the holder's directory serves every needle
    again; ``volume.tier.download -deleteRemote`` brings back a .dat whose
    sha256 is the original's and empties the tier; the volume is thawed.

    (b) A demotion on K1 under foreground traffic: a 001 volume of its own
    collection filled with seeded TIER_NEEDLE needles (TIER_BYTES) and
    sealed on both holders; the source's .dat linked aside. TIER_READERS
    readers and TIER_WRITERS writers (_fg_load) run through a healthy
    window as long as the cap's floor, then the same load through GET
    /cluster/tiering?scan=1. The volume must be warm with demotions_ok 1;
    no read failed or differed, reads ran inside the demotion, no write
    failed and none landed in the sealed volume; every needle after the
    flip equals its write; the hot replica is gone everywhere and
    /cluster/ec_status lists the volume; each of the 14 shards has the
    sha256 of the kept .dat encoded through K1's plain version on the
    card (no launch); K1's launches on the source, from its
    /admin/devices, equal its dispatches and are > 0; the master's
    /metrics shows one ok demotion, hot_bytes demoted and one warm
    volume. Prints each part's numbers, the demotion's wall and MB/s
    under the cap, read p50/p99 healthy and during, write p50/p99,
    overlap_frac and the trace id, then the leg's numbers as JSON.
    Stops every server and the master in a finally."""
    ec, _, _ = port
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.ops.device_stats import K1
    from seaweedfs_tpu_torch.server.http_util import (get_json, http_call,
                                                      post_json)
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.stats.metrics import parse_prometheus_text
    from seaweedfs_tpu_torch.storage.backend import (clear_backends,
                                                     configure_backends)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import DiskLocation
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    rng = np.random.default_rng(seed)
    numbers = {}
    tier_dir = os.path.join(work, "tier-cold")
    configure_backends({"dir": {"cold": {"path": tier_dir}}})
    master = MasterServer(port=0, pulse_seconds=CLUSTER_PULSE_S, seed=seed,
                          repair_interval=0, vacuum_interval=0,
                          tier_rate_mbps=TIER_RATE_MBPS, tier_age=0).start()
    murl = master.url
    servers = []
    try:
        for i in range(TIER_SERVERS):
            d = os.path.join(work, f"tier-{i}")
            os.makedirs(d)
            servers.append(VolumeServer(
                fast_port=-1, port=0, directories=[d], device=SERVER_DEVICE,
                master_url=murl, pulse_seconds=CLUSTER_PULSE_S,
                max_volume_counts=[TIER_SLOTS], scrub_idle_s=0).start())
        by_url = {vs.url: vs for vs in servers}

        def beat():
            for vs in servers:
                vs.heartbeat_once()

        def fill(collection, count, replication=""):
            post_json(f"http://{murl}/vol/grow?collection={collection}"
                      f"&count=1" + (f"&replication={replication}"
                                     if replication else ""))
            bodies = [rng.bytes(TIER_NEEDLE) for _ in range(count)]

            def put(i):
                a = op.assign(murl, collection=collection,
                              replication=replication)
                op.upload(a["url"], a["fid"], bodies[i], filename=f"t{i}")
                return a["fid"], bodies[i]
            with ThreadPoolExecutor(4) as pool:
                payloads = dict(pool.map(put, range(count)))
            vids = {parse_file_id(fid)[0] for fid in payloads}
            if len(vids) != 1:
                raise AssertionError(f"tiering: {collection} needles in "
                                     f"volumes {vids}")
            return vids.pop(), payloads

        # (a) the dir backend
        t0 = time.perf_counter()
        vid_a, cold = fill("cold", TIER_DIR_NEEDLES)
        beat()
        holder = next(vs for vs in servers if vs.store.find_volume(vid_a))
        dat = holder.store.find_volume(vid_a).dat_path
        size_a, sha_a = os.path.getsize(dat), _sha(dat)
        t1 = time.perf_counter()
        _shell(murl, f"volume.tier.upload -volumeId {vid_a} -dest dir.cold")
        up_s = time.perf_counter() - t1
        obj = os.path.join(tier_dir, os.path.basename(dat))
        if os.path.exists(dat) or _sha(obj) != sha_a:
            raise AssertionError("tiering (a): the .dat was not moved whole "
                                 "onto the dir backend")
        t1 = time.perf_counter()
        for fid, body in cold.items():
            if op.read_file(murl, fid) != body:
                raise AssertionError(f"tiering (a): GET {fid} through the "
                                     f"RemoteFile differs")
        remote_read_s = time.perf_counter() - t1
        loc = DiskLocation(os.path.dirname(dat))
        try:
            v = loc.load_volume(vid_a)
            if not v.readonly or v.dat.name != f"dir.cold/" \
                    f"{os.path.basename(dat)}":
                raise AssertionError(f"tiering (a): cold reopen {v.dat}")
            for fid, body in cold.items():
                _, key, cookie = parse_file_id(fid)
                if v.read_needle(Needle(id=key, cookie=cookie)).data != body:
                    raise AssertionError(f"tiering (a): cold reopen reads "
                                         f"{fid} wrong")
        finally:
            loc.close()
        t1 = time.perf_counter()
        _shell(murl, f"volume.tier.download -volumeId {vid_a} -deleteRemote")
        down_s = time.perf_counter() - t1
        if _sha(dat) != sha_a or os.listdir(tier_dir):
            raise AssertionError("tiering (a): the downloaded .dat differs "
                                 "or the tier kept its object")
        _post(holder.url, f"/admin/volume/readonly?volume={vid_a}"
                          f"&readonly=false")
        numbers["dir"] = {
            "volume": vid_a, "dat_bytes": size_a, "needles": len(cold),
            "upload_s": round(up_s, 4),
            "upload_mb_s": round(size_a / up_s / 1e6, 1),
            "remote_get_mb_s": round(
                len(cold) * TIER_NEEDLE / remote_read_s / 1e6, 1),
            "download_s": round(down_s, 4),
            "wall_s": round(time.perf_counter() - t0, 3)}
        print(f"tiering (a): volume {vid_a} ({size_a} B) onto dir.cold in "
              f"{up_s:.3f} s, {len(cold)} GETs through the RemoteFile at "
              f"{numbers['dir']['remote_get_mb_s']} MB/s, a cold "
              f"DiskLocation reopen served each, download -deleteRemote in "
              f"{down_s:.3f} s: sha256 the original's")

        # (b) a demotion on K1 under foreground traffic
        t0 = time.perf_counter()
        vid, payloads = fill("tier", TIER_BYTES // TIER_NEEDLE, "001")
        fill_s = time.perf_counter() - t0
        holders = [u for u, vs in by_url.items() if vs.store.find_volume(vid)]
        if len(holders) != 2:
            raise AssertionError(f"tiering: volume {vid} on {holders}")
        for u in holders:
            _post(u, f"/admin/volume/readonly?volume={vid}")
        beat()
        _wait_for("the sealed volume in the master's view", lambda: all(
            r.get("read_only") for r in get_json(
                f"http://{murl}/cluster/volumes")["volumes"][str(vid)]),
            TIER_WAIT_S)
        source = get_json(f"http://{murl}/cluster/volumes")[
            "volumes"][str(vid)][0]["url"]
        kept = os.path.join(work, "tier-kept")
        os.makedirs(kept)
        base_src = by_url[source].store.find_volume(vid).file_name()
        ref_base = os.path.join(kept, os.path.basename(base_src))
        _link(base_src + ".dat", ref_base + ".dat")
        dat_bytes = os.path.getsize(ref_base + ".dat")
        shard_bytes = ec.TOTAL_SHARDS * ec.ec_shard_base_size(dat_bytes)
        floor_s = shard_bytes / (TIER_RATE_MBPS * 1e6)
        _, lat_h, rfail_h, wlat_h, wfail_h, wfids_h = _fg_load(
            np, lambda: time.sleep(max(2.0, floor_s)), murl, payloads, seed,
            "healthy")
        dev0 = get_json(f"http://{source}/admin/devices")["stats"]
        t1 = time.perf_counter()
        out, lat_d, rfail_d, wlat_d, wfail_d, wfids_d = _fg_load(
            np, lambda: get_json(f"http://{murl}/cluster/tiering?scan=1",
                             timeout=600), murl, payloads, seed + 7,
            "demotion")
        demote_s = time.perf_counter() - t1
        dev1 = get_json(f"http://{source}/admin/devices")["stats"]
        st = out["volumes"].get(str(vid), {})
        if st.get("state") != "warm" or out["demotions_ok"] != 1 or \
                out["demotions_failed"]:
            raise AssertionError(f"tiering: {out}")
        failures = rfail_h + rfail_d + wfail_h + wfail_d
        if failures or not lat_d or not wlat_d:
            raise AssertionError(f"tiering: {len(failures)} foreground "
                                 f"failures ({failures[:3]}), {len(lat_d)} "
                                 f"reads and {len(wlat_d)} writes during "
                                 f"the demotion")
        if any(parse_file_id(f)[0] == vid for f in wfids_h + wfids_d):
            raise AssertionError(f"tiering: a write landed in the sealed "
                                 f"volume {vid}")
        _wait_for("the hot replicas gone", lambda: not any(
            vs.store.find_volume(vid) for vs in servers) and str(vid) not in
            get_json(f"http://{murl}/cluster/volumes")["volumes"],
            TIER_WAIT_S)
        t1 = time.perf_counter()
        for fid, body in payloads.items():
            if op.read_file(murl, fid) != body:
                raise AssertionError(f"tiering: GET {fid} after the flip "
                                     f"differs")
        flip_read_s = time.perf_counter() - t1
        placed = get_json(f"http://{murl}/cluster/ec_status")[
            "volumes"].get(str(vid), {}).get("shards", {})
        before = _k1()
        ec.write_ec_files(ref_base, codec=_plain_card_codec(np, ec))
        if _k1() != before:
            raise AssertionError("tiering: the reference encode launched K1")
        want = _shas([ref_base + ec.to_ext(s)
                      for s in range(ec.TOTAL_SHARDS)])
        paths = []
        for sid in range(ec.TOTAL_SHARDS):
            urls = placed.get(str(sid), [])
            if len(urls) != 1:
                raise AssertionError(f"tiering: shard {sid} held by {urls}")
            ev = by_url[urls[0]].store.find_ec_volume(vid)
            paths.append(ev.base_name + ec.to_ext(sid))
        if _shas(paths) != want:
            raise AssertionError("tiering: a demoted shard differs from the "
                                 "plain encode of the kept .dat")
        launches = dev1["launches"].get(K1, 0) - dev0["launches"].get(K1, 0)
        dispatches = dev1["dispatches"].get(K1, 0) - \
            dev0["dispatches"].get(K1, 0)
        if launches != dispatches or launches < 1:
            raise AssertionError(f"tiering: K1 on the source {launches} "
                                 f"launches for {dispatches} dispatches")
        series = {}
        for fam in parse_prometheus_text(http_call(
                "GET", f"http://{murl}/metrics").decode()):
            if fam["name"].startswith("SeaweedFS_master_tier_"):
                for name, labels, value in fam["samples"]:
                    series[(name, tuple(labels))] = value
        want_series = {
            ("SeaweedFS_master_tier_demotions_total",
             (("result", "ok"),)): 1,
            ("SeaweedFS_master_tier_demoted_bytes_total", ()):
                st["hot_bytes"],
            ("SeaweedFS_master_tier_volumes", (("state", "warm"),)): 1}
        if any(series.get(k) != v for k, v in want_series.items()) or \
                st["hot_bytes"] != dat_bytes:
            raise AssertionError(f"tiering: the master's tier series "
                                 f"{series}, hot_bytes {st['hot_bytes']} "
                                 f"of a {dat_bytes} B .dat")
        def ms(xs):
            return [round(_pct(xs, q) * 1e3, 3) for q in (0.5, 0.99)]

        numbers["demotion"] = {
            "volume": vid, "needles": len(payloads), "dat_bytes": dat_bytes,
            "shard_bytes": shard_bytes, "fill_s": round(fill_s, 3),
            "rate_cap_mb_s": TIER_RATE_MBPS, "floor_s": round(floor_s, 3),
            "wall_s": st["wall_s"], "scan_s": round(demote_s, 3),
            "mb_s": st["demote_mbps"],
            "shard_mb_s": round(shard_bytes / st["wall_s"] / 1e6, 2),
            "overlap_frac": st["overlap_frac"], "trace_id": st["trace_id"],
            "k1_launches": launches,
            "reads": {"healthy": len(lat_h), "during": len(lat_d)},
            "read_ms": {"healthy": ms(lat_h), "during": ms(lat_d)},
            "writes": {"healthy": len(wlat_h), "during": len(wlat_d)},
            "write_ms": {"healthy": ms(wlat_h), "during": ms(wlat_d)},
            "flip_read_mb_s": round(TIER_BYTES / flip_read_s / 1e6, 1)}
        d = numbers["demotion"]
        print(f"tiering (b): volume {vid} ({dat_bytes} B, {len(payloads)} "
              f"needles, filled in {fill_s:.2f} s) demoted from {source} in "
              f"{st['wall_s']} s: {st['demote_mbps']} MB/s of .dat, "
              f"{d['shard_mb_s']} MB/s of the {shard_bytes} shard bytes "
              f"under the {TIER_RATE_MBPS} MB/s cap (floor {floor_s:.3f} s),"
              f" {launches} K1 launches on the source = its dispatches, "
              f"overlap_frac {st['overlap_frac']}, trace {st['trace_id']}")
        print(f"tiering (b): reads p50/p99 ms healthy "
              f"{d['read_ms']['healthy']} ({len(lat_h)} GETs), during the "
              f"demotion {d['read_ms']['during']} ({len(lat_d)} GETs); "
              f"writes p50/p99 ms healthy {d['write_ms']['healthy']} "
              f"({len(wlat_h)}), during {d['write_ms']['during']} "
              f"({len(wlat_d)}); 0 failures; after the flip every needle "
              f"equal at {d['flip_read_mb_s']} MB/s; 14 shards = the plain "
              f"encode of the kept .dat; the master's tier series as "
              f"stated")
        print(f"tiering: {json.dumps(numbers)}")
        numbers["launches"] = launches
        return numbers
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
        clear_backends()


def mesh_geometries(sharded_ec):
    """(label, coeffs, widths) of step 16's K1 products: the encode rows
    at a mesh lane (an 8 MiB slab over two positions) and the two (4,5)
    blocks of the (6,7,8,9) decode plan that the (2,2) mesh's 'shard'
    positions multiply."""
    from seaweedfs_tpu_torch.ops import gf256
    dec = sharded_ec.decode_coeffs(10, 4, list(range(6)) + [10, 11, 12, 13],
                                   [6, 7, 8, 9])
    return [("mesh lane encode", gf256.build_matrix(10, 14)[10:],
             (1, 4407, MESH_LANE_N, MESH_LANE_N + 1)),
            ("mesh rebuild partial", dec[:, :5],
             (1, 4407, MESH_STEP_N, MESH_STEP_N + 1)),
            ("mesh rebuild partial, second block", dec[:, 5:],
             (MESH_STEP_N,))]


_RANK = r"""
import json, sys, time
sys.path.insert(0, sys.argv[3])
import torch
from seaweedfs_tpu_torch.ops import rs_hopper
from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS
from seaweedfs_tpu_torch.parallel import init_distributed, multihost_ec_step
from seaweedfs_tpu_torch.parallel.multihost import shutdown
dev = sys.argv[5]
init_distributed(sys.argv[1], 2, int(sys.argv[2]), devices=[dev],
                 backend="gloo")
if dev.startswith("cuda"):
    torch.zeros(1, device=dev)
    rs_hopper._library()
print("READY", flush=True)
if sys.stdin.readline().strip() == "go":
    DEVICE_STATS.reset_counts()
    t0 = time.perf_counter()
    out = multihost_ec_step(k=10, m=4, n_per_device=int(sys.argv[4]))
    if dev.startswith("cuda"):
        torch.cuda.synchronize()
    out["seconds"] = round(time.perf_counter() - t0, 3)
    print("RANK " + json.dumps(out), flush=True)
shutdown()
"""


class Ranks:
    """Step 16 (c)'s two rank processes, each with one position on
    MESH_DEVICE, joined over gloo. They start, build their CUDA context and
    join the group while the smoke runs (a) and (b), and wait for ``go``
    on their standard input. A rank that does not report READY within
    RANK_START_S, or fails, fails the run."""

    def __init__(self, work):
        self.log = os.path.join(work, "rank{}.log")
        self.coord = f"127.0.0.1:{_free_ports(1)[0]}"
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK, self.coord, str(r), ROOT,
             str(MESH_STEP_N), MESH_DEVICE], cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=open(self.log.format(r), "wb"),
            text=True) for r in (0, 1)]

    def _line(self, r, prefix, timeout):
        proc, deadline = self.procs[r], time.monotonic() + timeout
        while time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if ready:
                line = proc.stdout.readline()
                if not line:
                    break
                if line.startswith(prefix):
                    return line
        with open(self.log.format(r), "rb") as f:
            err = f.read()[-3000:].decode("utf-8", "replace")
        raise AssertionError(f"rank {r} sent no {prefix!r} line (exit "
                             f"{proc.poll()}): {err}")

    def run(self):
        """Both ranks ready, then go; each rank's summary."""
        t0 = time.perf_counter()
        for r in (0, 1):
            self._line(r, "READY", RANK_START_S)
        ready_s = time.perf_counter() - t0
        for proc in self.procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        out = [json.loads(self._line(r, "RANK ", RANK_START_S)[5:])
               for r in (0, 1)]
        for r, proc in enumerate(self.procs):
            if proc.wait(timeout=60) != 0:
                raise AssertionError(f"rank {r} exited {proc.returncode}")
        return out, ready_s

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
            proc.stdin.close()


def mesh_codec_leg(np, port, work, base, res, seed):
    """Step 16 (a): the main volume encoded and a seeded 4 rebuilt
    through MeshCodec over two 'data' positions on the one card, in a
    directory of its own over a hard link to the .dat."""
    ec, ops, _ = port
    from seaweedfs_tpu_torch.parallel import MeshCodec
    from seaweedfs_tpu_torch.parallel.mesh import make_codec_mesh
    k, m = ec.DATA_SHARDS, ec.PARITY_SHARDS
    total = k + m
    d = os.path.join(work, "mesh")
    os.makedirs(d)
    mbase = os.path.join(d, "1")
    _link(base + ".dat", mbase + ".dat")
    mesh = make_codec_mesh([MESH_DEVICE] * 2)
    codec = MeshCodec(k, m, mesh=mesh)
    print(f"mesh codec over {mesh}: two 'data' positions on one card (an "
          f"exactness check of the multi-device path, not a multi-GPU "
          f"speed)")
    out = {}
    lost = _seeded4(np, seed, total)
    for what in ("encode", f"rebuild {lost}"):
        st = {}
        start = _k1()
        t0 = time.perf_counter()
        if what == "encode":
            ec.write_ec_files(mbase, codec=codec, stats=st)
        else:
            for sid in lost:
                os.remove(mbase + ec.to_ext(sid))
            if ec.rebuild_ec_files(mbase, codec=codec, stats=st) != \
                    list(lost):
                raise AssertionError(f"mesh rebuild of {lost} failed")
        secs = time.perf_counter() - t0
        launches = _k1() - start
        _check_shas(ec, mbase, res["shas"], f"mesh {what}")
        busy = st["device_busy_frac"]
        if st["mesh_dispatches"] != res["n_slabs"] or \
                st["dispatches"] != res["n_slabs"] or \
                st["dispatch_width_devices"] != 2 or \
                sorted(busy.values()) != [1.0, 1.0] or \
                st["bitmat_uploads"] != 1 or \
                launches != 2 * st["mesh_dispatches"]:
            raise AssertionError(f"mesh {what}: counters {st}, {launches} "
                                 f"K1 launches; want {res['n_slabs']} mesh "
                                 f"dispatches over 2 positions evenly, one "
                                 f"upload, 2 launches each")
        moved = VOLUME_BYTES if what == "encode" else st["survivor_bytes"]
        out[what.split()[0]] = {
            "secs": round(secs, 3), "mb_s": round(moved / secs / 1e6, 1),
            "dispatches": st["dispatches"],
            "mesh_dispatches": st["mesh_dispatches"], "launches": launches,
            "busy": busy, "mesh_device_bytes": st["mesh_device_bytes"]}
        print(f"mesh {what}: {moved / secs / 1e6:.1f} MB/s ({secs:.2f} s), "
              f"{st['mesh_dispatches']} mesh dispatches = slabs, width "
              f"{st['dispatch_width_devices']} positions, busy {busy}, "
              f"bytes {st['mesh_device_bytes']}, {launches} K1 launches = "
              f"2 x sharded dispatches, {st['bitmat_uploads']} upload, "
              f"phases {st['phases']} — 14 shards sha256-identical to "
              f"step 5's")
    shutil.rmtree(d)
    return out


def mesh_crossover_leg(np, port):
    """Step 16 (a): a sub-1 MiB product through the two-position mesh
    codec runs at position 0 alone (width 1, no mesh dispatch)."""
    _, ops, _ = port
    from seaweedfs_tpu_torch.ops import telemetry
    from seaweedfs_tpu_torch.parallel import MeshCodec
    from seaweedfs_tpu_torch.parallel.mesh import make_codec_mesh
    codec = MeshCodec(10, 4, mesh=make_codec_mesh([MESH_DEVICE] * 2))
    data = np.random.default_rng(5).integers(0, 256, (10, 4096),
                                             dtype=np.uint8)
    before = telemetry.STATS.snapshot()
    got = codec.encode(data)
    moved = telemetry.delta(before)
    if moved["mesh_dispatches"] != 0 or \
            moved["dispatch_width_devices"] != 1 or \
            not np.array_equal(got, ops.NumpyCodec(10, 4).encode(data)):
        raise AssertionError(f"mesh crossover: {moved}")
    print(f"mesh crossover: (10, 4096) = {10 * 4096} B < 1 MiB ran at one "
          f"position: {moved['dispatches']} dispatch, 0 mesh dispatches, "
          f"width {moved['dispatch_width_devices']}")


def sharded_step_leg(np):
    """Step 16 (b): distributed_ec_step on a (2,2) mesh of four positions
    on MESH_DEVICE at MESH_STEP_N columns a position."""
    from seaweedfs_tpu_torch.parallel import distributed_ec_step, make_mesh
    mesh = make_mesh((2, 2), devices=[MESH_DEVICE] * 4)
    t0 = time.perf_counter()
    parity, rebuilt, diff = distributed_ec_step(mesh, 10, 4, MESH_STEP_N)
    secs = time.perf_counter() - t0
    if diff != 0:
        raise AssertionError(f"distributed_ec_step: max |diff| {diff}")
    print(f"distributed_ec_step on {mesh}: diff 0, {secs:.2f} s "
          f"(seeded data, encode over 'data' with parity rows over 'shard', "
          f"rebuild of 6-9 with its contraction over 'shard', the two "
          f"(4,5) partials XOR-folded)")
    return {"parity": parity, "secs": round(secs, 3)}


def check_step_parity(torch, np, ops, parity):
    """Step 16 (b)'s parity against TorchCodec's single-device K1 output
    in full and the numpy oracle on sampled columns."""
    n = 2 * MESH_STEP_N
    data = np.random.default_rng(0).integers(0, 256, (10, n), dtype=np.uint8)
    single = ops.get_codec(10, 4, device=MESH_DEVICE).encode(data)
    if not np.array_equal(parity, single):
        raise AssertionError("distributed_ec_step parity != TorchCodec's")
    cols = np.random.default_rng(3).choice(n, 4096, replace=False)
    if not np.array_equal(parity[:, cols],
                          ops.NumpyCodec(10, 4).encode(data[:, cols])):
        raise AssertionError("distributed_ec_step parity != numpy oracle")
    print(f"distributed_ec_step parity (4, {n}) equal in full to "
          f"TorchCodec's single-device K1 output and to the numpy oracle on "
          f"4096 sampled columns")


def check_ranks(torch, ranks, ready_s):
    """Step 16 (c): both ranks' summaries."""
    kind = torch.cuda.get_device_name(0)
    for r, out in enumerate(ranks):
        if not out["ok"] or out["process_index"] != r or \
                out["process_count"] != 2 or out["global_devices"] != 2 or \
                out["mesh_shape"] != {"data": 1, "shard": 2} or \
                out["backend"] != "gloo" or out["device_kind"] != kind or \
                out["k1_launches"] != 2 or \
                out["parity_shards_checked"] < 1 or \
                out["rebuilt_shards_checked"] < 1:
            raise AssertionError(f"rank {r}: {out}")
        print(f"rank {r}: {json.dumps(out)}")
    print(f"two ranks over gloo on one card: both ok (a further "
          f"{ready_s:.2f} s for both to be ready after (a) and (b)), K1 "
          f"launches by rank "
          f"{[out['k1_launches'] for out in ranks]}, each rank's blocks "
          f"checked against the numpy oracle")


S3_BUCKET = "smoke-bucket"  # step 20's bucket, and so its collection
S3_OBJECTS = 24             # its objects, log-uniform sizes between
S3_MIN = 256 << 10          # (the small-dispatch crossover: a needle at
S3_MAX = 8 << 20            # least this wide over the lost shard launches)
S3_BYTES = 48 << 20         # their data (a production bucket cut for time)
S3_PARTS = (5 << 20, 5 << 20, 2 << 20)  # the multipart upload's parts
S3_DELETED = 2              # keys of one DeleteObjects
S3_TIER_NEEDLES = 16        # the small sealed volume's 64 KiB needles
S3_AK, S3_SK = "smoke-access", "smoke/secret+key"
EVENT_TOPIC = "filer-events"  # step 22's broker topic of the filer's events
REPLICA_BUCKET = "replica"  # filer.replicate's s3 sink bucket
EVENT_TEXT_BYTES = 1 << 20  # the text object fs.cat prints
EVENT_DAV_BYTES = 3 << 20   # the file WebDAV PUTs, moves and copies
EVENT_WAIT_S = 60.0         # bound on each of step 22's waits
MTLS_COLLECTION = "bench"   # step 21's collection (benchmark and upload)
MTLS_GROWTH = 3             # master.toml's copy_1: volumes a growth makes
MTLS_BENCH_N = 512          # benchmark -n
MTLS_BENCH_SIZE = 4096      # benchmark -size
MTLS_FILES = 12             # uploaded files, log-uniform sizes between
MTLS_MIN = 256 << 10        # these two
MTLS_MAX = 4 << 20
MTLS_BYTES = 24 << 20       # about their total
MTLS_JWT = "smoke-signing-key"
MTLS_INDEX = {"b": "compact", "c": "sortedfile"}  # the volume processes'
                                                  # needle maps (-index)
MTLS_DC = {"a": "dc-a", "b": "dc-b", "c": "dc-c"}  # -dataCenter: one
                                  # MTLS_COLLECTION volume grown in each


class S3Stack:
    """Step 20's stack as a user starts it: ``python3 -m
    seaweedfs_tpu_torch.command.cli server -filer -s3`` in a process of
    its own on free ports, its volume server on the card (``-ec.backend
    cuda``) with its native plane, its master's repair loop off
    (SW_REPAIR_INTERVAL_S=0: the step's lost shard is ec.rebuild's), an
    IAM identity and an ``s3`` tier ("s3.self") whose endpoint is its
    own gateway. With ``events`` (step 22's ``EventPlane``) it also
    serves WebDAV (``-webdav -webdavPort``) and its filer publishes every
    metadata event to the plane's broker through the webhook publisher,
    enabled by ``WEED_NOTIFICATION_WEBHOOK_*`` in its environment.
    ``spawn`` starts it, ``wait`` reads its addresses, ``stop`` sends
    SIGTERM and wants exit code 0."""

    def __init__(self, work, events=None):
        self.dir = os.path.join(work, "s3-stack")
        os.makedirs(self.dir)
        self.events = events
        self.ports = _free_ports(5)
        self.master, self.volume, self.filer, self.s3, self.webdav = (
            f"127.0.0.1:{p}" for p in self.ports)
        self.proc = None
        self.log = os.path.join(work, "s3-stack.log")

    def spawn(self):
        iam = os.path.join(self.dir, "iam.json")
        with open(iam, "w") as f:
            json.dump({"identities": [{
                "name": "smoke", "actions": ["Admin"],
                "credentials": [{"accessKey": S3_AK,
                                 "secretKey": S3_SK}]}]}, f)
        tier = os.path.join(self.dir, "tier.json")
        with open(tier, "w") as f:
            json.dump({"s3": {"self": {
                "endpoint": self.s3, "bucket": "tier",
                "access_key": S3_AK, "secret_key": S3_SK}}}, f)
        mport, vport, fport, sport, wport = self.ports
        env = dict(os.environ, SW_REPAIR_INTERVAL_S="0")
        extra = []
        if self.events is not None:
            extra = ["-webdav", "-webdavPort", str(wport)]
            env.update(WEED_NOTIFICATION_WEBHOOK_ENABLED="true",
                       WEED_NOTIFICATION_WEBHOOK_URL=(
                           f"http://{self.events.broker}/queue/publish?"
                           f"topic={EVENT_TOPIC}"))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.command.cli",
             "server", "-filer", "-s3", "-s3Config", iam,
             "-tierConfig", tier, "-ec.backend", "cuda",
             "-dir", os.path.join(self.dir, "data"), "-max", "64",
             "-masterPort", str(mport), "-port", str(vport),
             "-filerPort", str(fport), "-s3Port", str(sport),
             "-pulseSeconds", "1"] + extra,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=open(self.log, "wb"),
            text=True, env=env)
        # a thread reads the stack's lines as they come (and drains the
        # pipe after): a select on the pipe would miss lines that the
        # reader's buffer already holds
        self.lines = queue.Queue()
        threading.Thread(target=self._read, args=(self.proc.stdout,),
                         daemon=True).start()
        return self

    def _read(self, out):
        for line in out:
            self.lines.put(line.strip())
        self.lines.put(None)

    def wait(self):
        deadline = time.monotonic() + HOLDER_START_S
        last = f"webdav on http://{self.webdav}" \
            if self.events is not None \
            else f"s3 gateway on {self.s3}"
        lines = []
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=0.5)
            except queue.Empty:
                continue
            if line is None:
                break
            lines.append(line)
            if line.startswith(last.split(" on ")[0] + " on"):
                break
        if not lines or lines[-1] != last:
            with open(self.log, "rb") as f:
                err = f.read()[-2000:].decode("utf-8", "replace")
            raise AssertionError(f"s3 stack did not start (exit "
                                 f"{self.proc.poll()}): {lines} {err}")
        self.plane = next((ln.split()[-1] for ln in lines
                           if ln.startswith("native read plane on")), None)
        return lines

    def stop(self):
        """SIGTERM; the exit code (it must be 0)."""
        if self.proc is None:
            return 0
        proc, self.proc = self.proc, None
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        return rc

    stop_processes = stop


class S3Client:
    """A SigV4 client of the port's ``s3/auth`` over one kept-alive
    connection; each call returns (status, headers, body, ms)."""

    def __init__(self, hostport):
        import http.client
        self.hostport = hostport
        self.conn = http.client.HTTPConnection(hostport, timeout=300)

    def __call__(self, method, path, body=b"", headers=None):
        from seaweedfs_tpu_torch.s3.auth import sign_request_v4
        h = sign_request_v4(method, f"http://{self.hostport}{path}",
                            dict(headers or {}), body, S3_AK, S3_SK)
        t0 = time.perf_counter()
        self.conn.request(method, path, body=body or None, headers=h)
        r = self.conn.getresponse()
        data = r.read()
        return r.status, dict(r.getheaders()), data, \
            (time.perf_counter() - t0) * 1e3

    def close(self):
        self.conn.close()


def _s3_plan(np, seed):
    """S3_OBJECTS (key, bytes): log-uniform sizes scaled to about
    S3_BYTES, under logs/d<day>/ (for the prefix and delimiter)."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(S3_MIN), np.log(S3_MAX), S3_OBJECTS))
    sizes = np.clip(sizes * S3_BYTES / sizes.sum(), S3_MIN,
                    S3_MAX).astype(int)
    return [(f"logs/d{i % 4}/part-{i:02d}.bin", rng.bytes(int(n)))
            for i, n in enumerate(sizes)]


def _check(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: {got!r}, want {want!r}")


def _objects_crossing(ec, stack, objects):
    """{(vid, sid): (objects whose needles cross that shard, those that
    cross it by at least S3_MIN)} over the bucket's EC volumes, from each
    volume's .ecx (ec/locate)."""
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
    from seaweedfs_tpu_torch.server.http_util import get_json
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    data = os.path.join(stack.dir, "data")
    vols, out = {}, {}
    try:
        for key in objects:
            entry = get_json(f"http://{stack.filer}/filer/meta/lookup?path="
                             f"/buckets/{S3_BUCKET}/{key}")["entry"]
            crossed = {}
            for c in entry["chunks"]:
                vid, nid, _ = parse_file_id(c["fid"])
                if vid not in vols:
                    vols[vid] = EcVolume(data, S3_BUCKET, vid)
                for iv in vols[vid].locate_needle(nid)[2]:
                    sid = iv.to_shard_id_and_offset(ec.LARGE_BLOCK_SIZE,
                                                    ec.SMALL_BLOCK_SIZE)[0]
                    crossed[(vid, sid)] = crossed.get((vid, sid), 0) + \
                        iv.size
            for vs, nbytes in crossed.items():
                n, wide = out.get(vs, (0, 0))
                out[vs] = (n + 1, wide + (nbytes >= S3_MIN))
    finally:
        for v in vols.values():
            v.close()
    return out


def _get_pass(s3, want, label):
    """GET every object through S3, sha256-identical; (ms list, MB/s)."""
    lat, t0 = [], time.perf_counter()
    for key, sha in want.items():
        st, _, body, ms = s3("GET", f"/{S3_BUCKET}/{key}")
        if st != 200 or hashlib.sha256(body).hexdigest() != sha["sha"]:
            raise AssertionError(f"s3 {label} GET {key}: {st}")
        lat.append(ms)
    wall = time.perf_counter() - t0
    return lat, sum(w["size"] for w in want.values()) / wall / 1e6


def s3_leg(np, port, work, seed, stack, keep=False):
    """Step 20: the filer and the S3 gateway on the port's own CLI stack
    (``S3Stack``, started before), objects read through a lost shard
    reconstructed on K1 in the stack's process. With ``keep`` the stack
    stays up for step 22, holding the bucket's objects (``objects``) and
    the shard this step lost (``lost``)."""
    from seaweedfs_tpu_torch.client import operation
    from seaweedfs_tpu_torch.server.http_util import get_json, http_call
    ec = port[0]
    t_step = time.perf_counter()
    lines = stack.wait()
    print("s3 stack: " + "; ".join(lines))
    vs, murl = stack.volume, stack.master
    k1_start = _devices_k1(vs)
    s3 = S3Client(stack.s3)
    try:
        # (b) write and read through S3
        _check("create bucket", s3("PUT", f"/{S3_BUCKET}")[0], 200)
        plan = _s3_plan(np, seed)
        want, put_ms, t0 = {}, [], time.perf_counter()
        for key, data in plan:
            st, h, _, ms = s3("PUT", f"/{S3_BUCKET}/{key}", data,
                              {"Content-Type": "application/octet-stream"})
            md5 = hashlib.md5(data).hexdigest()
            _check(f"PUT {key}", (st, h.get("ETag")), (200, f'"{md5}"'))
            put_ms.append(ms)
            want[key] = {"size": len(data), "etag": md5,
                         "sha": hashlib.sha256(data).hexdigest()}
        put_s = time.perf_counter() - t0
        put_bytes = sum(len(d) for _, d in plan)
        rng = np.random.default_rng(seed + 1)
        parts = [rng.bytes(n) for n in S3_PARTS]
        st, _, body, _ = s3("POST", f"/{S3_BUCKET}/multi/big.bin?uploads")
        uid = body.split(b"<UploadId>")[1].split(b"<")[0].decode()
        for i, p in enumerate(parts, 1):
            st, h, _, _ = s3("PUT", f"/{S3_BUCKET}/multi/big.bin?partNumber="
                             f"{i}&uploadId={uid}", p)
            _check(f"part {i}", (st, h.get("ETag")),
                   (200, f'"{hashlib.md5(p).hexdigest()}"'))
        st, _, body, _ = s3("POST", f"/{S3_BUCKET}/multi/big.bin?uploadId="
                            f"{uid}", b"<CompleteMultipartUpload/>")
        whole = b"".join(parts)
        multi_etag = hashlib.md5(b"".join(hashlib.md5(p).digest()
                                          for p in parts)).hexdigest() + \
            f"-{len(parts)}"
        _check("complete", (st, f"<ETag>&quot;{multi_etag}&quot;</ETag>"
                            .encode() in body or
                            f'<ETag>"{multi_etag}"</ETag>'.encode() in body),
               (200, True))
        want["multi/big.bin"] = {"size": len(whole), "etag": multi_etag,
                                 "sha": hashlib.sha256(whole).hexdigest()}
        src_key = plan[0][0]
        st, _, body, _ = s3("PUT", f"/{S3_BUCKET}/copies/first.bin", b"",
                            {"x-amz-copy-source": f"/{S3_BUCKET}/{src_key}"})
        _check("copy", (st, want[src_key]["etag"].encode() in body),
               (200, True))
        want["copies/first.bin"] = dict(want[src_key])
        st, _, body, _ = s3("GET", f"/{S3_BUCKET}?list-type=2&prefix=logs/"
                            f"&delimiter=/")
        import re as _re
        _check("list logs/ by /",
               (st, _re.findall(rb"<Prefix>(logs/d\d/)</Prefix>", body),
                b"<Contents>" in body),
               (200, [f"logs/d{d}/".encode() for d in range(4)], False))
        st, _, body, _ = s3("GET", f"/{S3_BUCKET}?list-type=2&prefix="
                            f"logs/d1/&delimiter=/")
        _check("list logs/d1/",
               _re.findall(rb"<Key>([^<]+)</Key>", body),
               sorted(k.encode() for k in want if k.startswith("logs/d1/")))
        st, h, body, _ = s3("HEAD", f"/{S3_BUCKET}/{src_key}")
        _check("HEAD", (st, h.get("Content-Length"), h.get("ETag"), body),
               (200, str(want[src_key]["size"]),
                f'"{want[src_key]["etag"]}"', b""))
        edge = S3_PARTS[0]
        st, h, body, _ = s3("GET", f"/{S3_BUCKET}/multi/big.bin",
                            headers={"Range": f"bytes={edge - 100}-"
                                              f"{edge + 99}"})
        _check("ranged GET across a chunk edge",
               (st, h.get("Content-Range"), body),
               (206, f"bytes {edge - 100}-{edge + 99}/{len(whole)}",
                whole[edge - 100:edge + 100]))
        doomed = [k for k, _ in plan[-S3_DELETED:]]
        st, _, body, _ = s3("POST", f"/{S3_BUCKET}?delete", (
            "<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>"
                                 for k in doomed) + "</Delete>").encode())
        _check("DeleteObjects", (st, body.count(b"<Deleted>")),
               (200, S3_DELETED))
        for k in doomed:
            want.pop(k)
            st, _, body, _ = s3("GET", f"/{S3_BUCKET}/{k}")
            _check(f"deleted {k}", (st, b"<Code>NoSuchKey</Code>" in body),
                   (404, True))
        healthy_ms, healthy_mbs = _get_pass(s3, want, "healthy")
        for key, w in want.items():
            body = http_call("GET", f"http://{stack.filer}/buckets/"
                             f"{S3_BUCKET}/{key}")
            _check(f"filer GET {key}", hashlib.sha256(body).hexdigest(),
                   w["sha"])
        print(f"s3 (b): {len(plan)} PUTs, {put_bytes} B, "
              f"{put_bytes / put_s / 1e6:.1f} MB/s, p50 "
              f"{_pct(put_ms, 0.5):.3f} ms, p99 {_pct(put_ms, 0.99):.3f} ms;"
              f" multipart {len(parts)} parts, copy, lists, HEAD, range, "
              f"DeleteObjects of {S3_DELETED}; healthy GETs "
              f"{healthy_mbs:.1f} MB/s, p50 {_pct(healthy_ms, 0.5):.3f} "
              f"ms, p99 {_pct(healthy_ms, 0.99):.3f} ms; every body "
              f"sha256-identical, through the filer too")

        # (c) encode the bucket's collection, lose the busiest shard
        t0, k_enc = time.perf_counter(), _devices_k1(vs)
        _shell(murl, f"ec.encode -collection {S3_BUCKET} -fullPercent 0 "
                     f"-quietFor 0")
        encode_s = time.perf_counter() - t0
        k_enc = _devices_k1(vs) - k_enc
        crossing = _objects_crossing(ec, stack, want)
        (vid, sid), (n_cross, n_wide) = max(
            crossing.items(), key=lambda kv: (kv[1][1], kv[1][0], kv[0]))
        shard = os.path.join(stack.dir, "data",
                             f"{S3_BUCKET}_{vid}{ec.to_ext(sid)}")
        lost_sha = _sha(shard)
        os.remove(shard)
        _post(vs, f"/admin/ec/unmount?volume={vid}&shards={sid}")

        def snap():
            return (_devices_k1(vs),
                    get_json(f"http://{vs}/status")["ec_degraded"],
                    get_json(f"http://{vs}/admin/plane/cache")["cache"])
        k0, e0, c0 = snap()
        cold_ms, cold_mbs = _get_pass(s3, want, "cold")
        k1, e1, c1 = snap()
        cold_launches = k1 - k0
        dev = e1["device_dispatches"] - e0["device_dispatches"]
        if cold_launches < 1 or cold_launches != dev or \
                e1["errors"] != e0["errors"]:
            raise AssertionError(f"s3 cold pass: {cold_launches} K1 "
                                 f"launches, {dev} device dispatches, "
                                 f"engine {e0} -> {e1}")
        warm_ms, warm_mbs = _get_pass(s3, want, "warm")
        k2, e2, c2 = snap()

        def delta(a, b, key):
            return (b or {}).get(key, 0) - (a or {}).get(key, 0)
        print(f"s3 (c): ec.encode -collection {S3_BUCKET} in "
              f"{encode_s:.2f} s ({k_enc} K1 launches); lost shard {sid} of volume {vid}, "
              f"crossed by {n_cross} objects ({n_wide} by >= {S3_MIN} B); "
              f"cold GETs {cold_mbs:.1f} MB/s, p50 {_pct(cold_ms, 0.5):.3f}"
              f" ms, p99 {_pct(cold_ms, 0.99):.3f} ms, {cold_launches} K1 "
              f"launches = the engine's device dispatches, "
              f"{e1['reads'] - e0['reads']} engine reads, plane "
              f"{delta(c0, c1, 'degraded_redirected')} redirected, "
              f"{delta(c0, c1, 'puts')} slabs published; warm GETs "
              f"{warm_mbs:.1f} MB/s, p50 {_pct(warm_ms, 0.5):.3f} ms, p99 "
              f"{_pct(warm_ms, 0.99):.3f} ms, {k2 - k1} K1 launches, "
              f"{e2['reads'] - e1['reads']} engine reads, plane slab-cache "
              f"hits {delta(c1, c2, 'hits')}, served "
              f"{delta(c1, c2, 'degraded_served')}, redirected "
              f"{delta(c1, c2, 'degraded_redirected')}")

        # (d) rebuild
        t0 = time.perf_counter()
        _shell(murl, f"ec.rebuild -collection {S3_BUCKET}")
        rebuild_s = time.perf_counter() - t0
        k3 = _devices_k1(vs)
        _check("rebuilt shard sha256", _sha(shard), lost_sha)
        after_ms, after_mbs = _get_pass(s3, want, "rebuilt")
        k4 = _devices_k1(vs)
        print(f"s3 (d): ec.rebuild in {rebuild_s:.2f} s ({k3 - k2} K1 "
              f"launches), shard {sid} sha256-identical; GETs "
              f"{after_mbs:.1f} MB/s, p50 {_pct(after_ms, 0.5):.3f} ms, "
              f"{k4 - k3} K1 launches")

        # (e) a small sealed volume onto the s3 tier at its own gateway
        _check("create tier bucket", s3("PUT", "/tier")[0], 200)
        needles, trng = {}, np.random.default_rng(seed + 2)
        for i in range(S3_TIER_NEEDLES):
            a = operation.assign(murl, collection="tiered")
            body = trng.bytes(64 << 10)
            operation.upload(a["url"], a["fid"], body, f"n{i}")
            needles[a["fid"]] = body
        by_vid = {}
        for fid in needles:
            by_vid.setdefault(int(fid.split(",")[0]), []).append(fid)
        tvid, tfids = max(by_vid.items(), key=lambda kv: len(kv[1]))
        t0 = time.perf_counter()
        _shell(murl, f"volume.tier.upload -volumeId {tvid} -dest s3.self")
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for fid in tfids:
            _check(f"remote GET {fid}",
                   http_call("GET", f"http://{vs}/{fid}"), needles[fid])
        remote_s = time.perf_counter() - t0
        _shell(murl, f"volume.tier.download -volumeId {tvid}")
        for fid in tfids:
            _check(f"downloaded GET {fid}",
                   http_call("GET", f"http://{vs}/{fid}"), needles[fid])
        print(f"s3 (e): volume {tvid} ({len(tfids)} needles) onto s3.self "
              f"(its own gateway) in {up_s:.2f} s, read remotely "
              f"{len(tfids) * (64 << 10) / remote_s / 1e6:.1f} MB/s, "
              f"downloaded back; every byte equal")
        k_end = _devices_k1(vs)
        stack.objects, stack.lost = want, (vid, sid)
    finally:
        s3.close()
        rc = 0 if keep else stack.stop()
    _check("s3 stack exit code after SIGTERM", rc, 0)
    numbers = {
        "objects": len(want), "put_mb_s": round(put_bytes / put_s / 1e6, 1),
        "put_p50_ms": round(_pct(put_ms, 0.5), 3),
        "put_p99_ms": round(_pct(put_ms, 0.99), 3),
        "get_mb_s": {"healthy": round(healthy_mbs, 1),
                     "cold": round(cold_mbs, 1), "warm": round(warm_mbs, 1),
                     "rebuilt": round(after_mbs, 1)},
        "get_p50_ms": {"healthy": round(_pct(healthy_ms, 0.5), 3),
                       "cold": round(_pct(cold_ms, 0.5), 3),
                       "warm": round(_pct(warm_ms, 0.5), 3)},
        "get_p99_ms": {"healthy": round(_pct(healthy_ms, 0.99), 3),
                       "cold": round(_pct(cold_ms, 0.99), 3),
                       "warm": round(_pct(warm_ms, 0.99), 3)},
        "lost": {"vid": vid, "sid": sid, "objects": n_cross,
                 "wide_objects": n_wide},
        "k1_launches": {"step": k_end - k1_start, "encode": k_enc,
                        "cold": cold_launches, "warm": k2 - k1,
                        "rebuild": k3 - k2, "rebuilt": k4 - k3},
        "plane": {"cold_redirected": delta(c0, c1, "degraded_redirected"),
                  "warm_hits": delta(c1, c2, "hits"),
                  "warm_served": delta(c1, c2, "degraded_served")},
        "encode_s": round(encode_s, 3), "rebuild_s": round(rebuild_s, 3),
        "wall_s": round(time.perf_counter() - t_step, 3)}
    print(card_line())
    print("s3 step: " + json.dumps(numbers))
    return numbers


class CliProcess:
    """``python3 -m seaweedfs_tpu_torch.command.cli <argv>`` in a process
    of its own, its stdout read on a thread (every line kept); ``stop``
    sends SIGTERM and returns the exit code."""

    def __init__(self, name, argv, work, cwd=None):
        self.name = name
        self.log = os.path.join(work, f"{name}.log")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.command.cli"]
            + list(argv), cwd=cwd or ROOT, stdout=subprocess.PIPE,
            stderr=open(self.log, "wb"), text=True)
        self.lines = []
        self._done = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
        self._done.set()

    def wait_line(self, prefix, timeout=HOLDER_START_S):
        _wait_for(f"{self.name}: a line starting {prefix!r}",
                  lambda: any(ln.startswith(prefix) for ln in self.lines)
                  or self.proc.poll() is not None, timeout)
        line = next((ln for ln in self.lines if ln.startswith(prefix)),
                    None)
        if line is None:
            with open(self.log, "rb") as f:
                err = f.read()[-2000:].decode("utf-8", "replace")
            raise AssertionError(f"{self.name} exited {self.proc.poll()}: "
                                 f"{self.lines[-5:]} {err}")
        return line

    def finish(self, timeout=120):
        """Wait for a command that ends by itself; its exit code."""
        rc = self.proc.wait(timeout=timeout)
        self._done.wait(10)
        return rc

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._done.wait(10)
        return rc

    stop_processes = stop


class EventPlane:
    """Step 22's processes that start with step 16's: the ``msgBroker``
    the stack's filer publishes to, and ``watch -since 0`` following the
    filer. ``spawn`` starts the broker (the stack's environment names
    it), ``watch`` the follower once the stack's ports are known."""

    def __init__(self, work):
        self.work = work
        self.broker = f"127.0.0.1:{_free_ports(1)[0]}"
        self.procs = {}

    def spawn(self):
        self.procs["broker"] = CliProcess(
            "msgBroker", ["msgBroker", "-port",
                          self.broker.split(":")[1]], self.work)
        return self

    def watch(self, filer):
        self.procs["watch"] = CliProcess(
            "watch", ["watch", "-filer", filer, "-since", "0"], self.work)

    def stop_processes(self):
        return {name: p.stop() for name, p in self.procs.items()}


def _dav(hostport, method, path, body=b"", headers=None):
    """(status, headers, body, ms) of one WebDAV request."""
    import http.client
    conn = http.client.HTTPConnection(hostport, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body or None,
                     headers=dict(headers or {}))
        r = conn.getresponse()
        data = r.read()
        return r.status, dict(r.getheaders()), data, \
            (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def _all_events(filer):
    """Every event of the filer's /filer/events since 0, in order."""
    from seaweedfs_tpu_torch.server.http_util import get_json
    out, since = [], 0.0
    while True:
        got = get_json(f"http://{filer}/filer/events?since={since!r}"
                       f"&timeout=0")["events"]
        if not got:
            return out
        out += got
        since = got[-1]["ts"]


def _all_messages(broker, topic):
    """Every message of a broker topic since 0, decoded, in order."""
    import base64
    from seaweedfs_tpu_torch.server.http_util import get_json
    out, since = [], 0.0
    while True:
        got = get_json(f"http://{broker}/queue/subscribe?topic={topic}"
                       f"&since={since!r}&timeout=0")["messages"]
        if not got:
            return out
        out += [json.loads(base64.b64decode(m["data"])) for m in got]
        since = got[-1]["ts"]


def event_leg(np, port, work, seed, stack, plane):
    """Step 22: the filer's event plane and gateways on step 20's stack
    (kept up by ``s3_leg``), through a second lost shard reconstructed
    on K1 in the stack's process."""
    import base64
    import re as _re

    from seaweedfs_tpu_torch.replication.sub import format_event
    from seaweedfs_tpu_torch.server.http_util import get_json
    ec = port[0]
    t_step = time.perf_counter()
    vs, filer, murl = stack.volume, stack.filer, stack.master
    bucket_dir = f"/buckets/{S3_BUCKET}"
    want = dict(stack.objects)
    s3 = S3Client(stack.s3)
    procs = []

    def snap():
        return (_devices_k1(vs),
                get_json(f"http://{vs}/status")["ec_degraded"])
    try:
        # (a) a text object for fs.cat, then lose a second shard: the one
        # the most objects cross, other than step 20's
        rng = np.random.default_rng(seed)
        raw = base64.b64encode(rng.bytes(EVENT_TEXT_BYTES * 3 // 4))
        text = b"\n".join(raw[i:i + 76] for i in range(0, len(raw), 76))
        st, _, _, _ = s3("PUT", f"/{S3_BUCKET}/text/notes.txt", text,
                         {"Content-Type": "text/plain"})
        _check("PUT text/notes.txt", st, 200)
        want["text/notes.txt"] = {"size": len(text),
                                  "sha": hashlib.sha256(text).hexdigest()}
        crossing = _objects_crossing(ec, stack, stack.objects)
        crossing.pop(stack.lost, None)
        (vid, sid), (n_cross, n_wide) = max(
            crossing.items(), key=lambda kv: (kv[1][1], kv[1][0], kv[0]))
        shard = os.path.join(stack.dir, "data",
                             f"{S3_BUCKET}_{vid}{ec.to_ext(sid)}")
        os.remove(shard)
        _post(vs, f"/admin/ec/unmount?volume={vid}&shards={sid}")
        print(f"events (a): lost shard {sid} of volume {vid}, crossed by "
              f"{n_cross} objects ({n_wide} by >= {S3_MIN} B)")
        k0, e0 = snap()

        # (b) filer.replicate from now on into an s3 sink on the stack's
        # own gateway, seeded by fs.meta.notify of the bucket
        _check("create replica bucket", s3("PUT", f"/{REPLICA_BUCKET}")[0],
               200)
        cursor = _all_events(filer)[-1]["ts"]
        cfg = os.path.join(work, "replicate.json")
        with open(cfg, "w") as f:
            json.dump({"source": {"filer": filer, "master": murl,
                                  "path": bucket_dir},
                       "sink": {"type": "s3", "endpoint": f"http://"
                                f"{stack.s3}", "bucket": REPLICA_BUCKET,
                                "access_key": S3_AK, "secret_key": S3_SK}},
                      f)
        t0 = time.perf_counter()
        rep = CliProcess("filer.replicate", [
            "filer.replicate", "-config", cfg, "-since", repr(cursor)], work)
        procs.append(rep)
        rep.wait_line("replicating ")
        notify = CliProcess("notify", [
            "shell", "-master", murl, "-filer", filer, "-c",
            f"fs.meta.notify {bucket_dir}"], work)
        procs.append(notify)
        _check("fs.meta.notify exit code", notify.finish(), 0)
        notified = int(_re.search(r"notified (\d+) entries",
                                  "\n".join(notify.lines)).group(1))

        def replica_keys():
            st, _, body, _ = s3("GET", f"/{REPLICA_BUCKET}?list-type=2"
                                        f"&max-keys=1000")
            return set(k.decode() for k in
                       _re.findall(rb"<Key>([^<]+)</Key>", body))
        _wait_for("every object in the replica bucket",
                  lambda: replica_keys() >= set(want), EVENT_WAIT_S)
        # the sink writes each object once it is read whole: wait for the
        # replicator's line of the last one too
        _wait_for("the replicator's lines", lambda: sum(
            ln.startswith("update ") for ln in rep.lines) >= notified,
            EVENT_WAIT_S)
        rep_s = time.perf_counter() - t0
        rep_lat = []
        for key, w in want.items():
            st, _, body, ms = s3("GET", f"/{REPLICA_BUCKET}/{key}")
            _check(f"replica GET {key}", (st, hashlib.sha256(
                body).hexdigest()), (200, w["sha"]))
            rep_lat.append(ms)
        _check("filer.replicate exit code after SIGTERM", rep.stop(), 0)
        rep_bytes = sum(w["size"] for w in want.values())
        print(f"events (b): filer.replicate of {bucket_dir} into s3 bucket "
              f"{REPLICA_BUCKET}: {len(want)} objects, {rep_bytes} B in "
              f"{rep_s:.3f} s ({rep_bytes / rep_s / 1e6:.1f} MB/s), "
              f"{notified} entries notified, every replica GET "
              f"sha256-identical (p50 {_pct(rep_lat, 0.5):.3f} ms, p99 "
              f"{_pct(rep_lat, 0.99):.3f} ms)")

        # (c) WebDAV: the bucket listed, its objects read, and a file put,
        # moved, copied, locked and deleted
        children = sorted(
            e["FullPath"].rsplit("/", 1)[1] + ("/" if e["IsDirectory"]
                                               else "")
            for e in get_json(f"http://{filer}/filer/meta/list?path="
                              f"{bucket_dir}&limit=1000")["entries"])
        st, _, body, _ = _dav(stack.webdav, "PROPFIND", bucket_dir,
                              headers={"Depth": "1"})
        listed = sorted(h.decode() for h in
                        _re.findall(rb"<D:href>([^<]+)</D:href>", body))
        _check("PROPFIND depth 1 of the bucket", (st, listed),
               (207, sorted([bucket_dir + "/"] + [
                   f"{bucket_dir}/{name}" for name in children])))
        dav_lat, t0 = [], time.perf_counter()
        for key, w in want.items():
            st, _, body, ms = _dav(stack.webdav, "GET", f"{bucket_dir}/{key}")
            _check(f"WebDAV GET {key}", (st, hashlib.sha256(
                body).hexdigest()), (200, w["sha"]))
            dav_lat.append(ms)
        dav_s = time.perf_counter() - t0
        big = max(want, key=lambda k: want[k]["size"])
        n = want[big]["size"]
        st, h, part, _ = _dav(stack.webdav, "GET", f"{bucket_dir}/{big}",
                              headers={"Range": f"bytes={n // 3}-"
                                                f"{n // 3 + 99_999}"})
        whole = s3("GET", f"/{S3_BUCKET}/{big}")[2]
        _check("WebDAV ranged GET", (st, h.get("Content-Range"), part),
               (206, f"bytes {n // 3}-{n // 3 + 99_999}/{n}",
                whole[n // 3:n // 3 + 100_000]))
        blob = rng.bytes(EVENT_DAV_BYTES)
        lock = (b'<?xml version="1.0" encoding="utf-8"?><D:lockinfo '
                b'xmlns:D="DAV:"><D:lockscope><D:exclusive/></D:lockscope>'
                b'<D:locktype><D:write/></D:locktype><D:owner>smoke'
                b'</D:owner></D:lockinfo>')
        dav_url = f"http://{stack.webdav}"
        got = [_dav(stack.webdav, "MKCOL", "/dav")[0],
               _dav(stack.webdav, "PUT", "/dav/new.bin", blob)[0],
               _dav(stack.webdav, "MOVE", "/dav/new.bin", headers={
                   "Destination": f"{dav_url}/dav/moved.bin"})[0],
               _dav(stack.webdav, "COPY", "/dav/moved.bin", headers={
                   "Destination": f"{dav_url}/dav/copy.bin"})[0]]
        st, h, _, _ = _dav(stack.webdav, "LOCK", "/dav/moved.bin", lock,
                           {"Timeout": "Second-60"})
        token = h.get("Lock-Token", "")
        got += [st, _dav(stack.webdav, "PUT", "/dav/moved.bin", b"x")[0],
                _dav(stack.webdav, "UNLOCK", "/dav/moved.bin",
                     headers={"Lock-Token": token})[0],
                _dav(stack.webdav, "DELETE", "/dav/copy.bin")[0],
                _dav(stack.webdav, "GET", "/dav/copy.bin")[0]]
        moved = _dav(stack.webdav, "GET", "/dav/moved.bin")
        _check("WebDAV MKCOL, PUT, MOVE, COPY, LOCK, refused PUT, UNLOCK, "
               "DELETE, GET of the deleted", (got, moved[0], hashlib.sha256(
                   moved[2]).hexdigest()),
               ([201, 201, 201, 201, 200, 423, 204, 204, 404], 200,
                hashlib.sha256(blob).hexdigest()))
        dav_bytes = sum(w["size"] for w in want.values())
        print(f"events (c): WebDAV PROPFIND of {bucket_dir} lists "
              f"{len(listed) - 1} children; {len(want)} GETs "
              f"{dav_bytes / dav_s / 1e6:.1f} MB/s, p50 "
              f"{_pct(dav_lat, 0.5):.3f} ms, p99 {_pct(dav_lat, 0.99):.3f} "
              f"ms, sha256-identical, one ranged; MKCOL, PUT "
              f"({EVENT_DAV_BYTES} B), MOVE, COPY, LOCK, PUT refused 423 "
              f"under the lock, UNLOCK, DELETE")

        # (d) one weed shell process with -filer
        meta = os.path.join(work, "bucket.meta.jsonl")
        t0 = time.perf_counter()
        sh = CliProcess("shell", [
            "shell", "-master", murl, "-filer", filer, "-c",
            f"fs.ls {bucket_dir}; fs.du {bucket_dir}; bucket.list; "
            f"bucket.create -name evt-bucket; bucket.list; bucket.delete "
            f"-name evt-bucket; bucket.list; fs.meta.save -o {meta} "
            f"{bucket_dir}; fs.cat {bucket_dir}/text/notes.txt"], work)
        procs.append(sh)
        _check("shell -filer exit code", sh.finish(), 0)
        shell_s = time.perf_counter() - t0
        out = "\n".join(sh.lines) + "\n"
        head, _, cat = out.partition(f"to {meta}\n")
        lines = head.splitlines()
        names = children
        du = f"{sum(w['size'] for w in want.values())} bytes\t{len(want)}" \
             f" files\t{bucket_dir}"
        with open(meta) as f:
            saved = [json.loads(ln)["FullPath"] for ln in f]
        buckets = sorted(
            e["FullPath"].rsplit("/", 1)[1]
            for e in get_json(f"http://{filer}/filer/meta/list?path="
                              f"/buckets&limit=1000")["entries"]
            if e["IsDirectory"])
        _check("shell -filer output", (
            lines, len(set(saved)), saved[0],
            hashlib.sha256(cat[:-1].encode()).hexdigest()), (
            names + [du] + buckets + ["created bucket evt-bucket"]
            + sorted(buckets + ["evt-bucket"])
            + ["deleted bucket evt-bucket"] + buckets
            + [f"saved {len(saved)} entries "], len(saved), bucket_dir,
            want["text/notes.txt"]["sha"]))
        print(f"events (d): shell -filer ({shell_s:.2f} s): fs.ls "
              f"{len(names)} entries, fs.du '{du}', bucket.list/create/"
              f"delete, fs.meta.save of {len(saved)} entries, fs.cat of "
              f"{len(text)} B sha256-identical")
        k1, e1 = snap()
        launches = k1 - k0
        dispatches = e1["device_dispatches"] - e0["device_dispatches"]
        if launches < 1 or launches != dispatches or \
                e1["errors"] != e0["errors"]:
            raise AssertionError(f"events: {launches} K1 launches in the "
                                 f"stack, {dispatches} device dispatches, "
                                 f"engine {e0} -> {e1}")
        print(f"events K1: {launches} launches in the stack's process = "
              f"its engine's device dispatches ({e1['reads'] - e0['reads']}"
              f" engine reads)")

        # (e) the broker's topic and watch's lines against /filer/events
        events = _all_events(filer)
        t0 = time.perf_counter()
        _wait_for("the broker's topic and watch's lines to catch up",
                  lambda: len(_all_messages(plane.broker, EVENT_TOPIC))
                  >= len(events) and len(plane.procs["watch"].lines)
                  >= len(events), EVENT_WAIT_S)
        lag_s = time.perf_counter() - t0
        events = _all_events(filer)
        msgs = _all_messages(plane.broker, EVENT_TOPIC)
        keys = [(e["event"]["newEntry"] or e["event"]["oldEntry"])["path"]
                for e in events]
        _check("broker events = /filer/events, key for key and in order",
               ([m["key"] for m in msgs], [m["event"] for m in msgs]),
               (keys, [e["event"] for e in events]))
        watch = plane.procs.pop("watch")
        watch_rc = watch.stop()
        watch_lines = list(watch.lines)
        _check("watch's lines = format_event of /filer/events",
               (watch_rc, watch_lines),
               (0, [format_event(e["ts"], e["event"]) for e in events]))
        broker_rc = plane.procs.pop("broker").stop()
        _check("msgBroker exit code after SIGTERM", broker_rc, 0)
        print(f"events (e): {len(events)} filer events = {len(msgs)} "
              f"broker messages (topic {EVENT_TOPIC}, the filer's webhook "
              f"publisher) = {len(watch_lines)} watch lines, caught up "
              f"{lag_s:.3f} s after the last")
    finally:
        s3.close()
        for p in procs:
            p.stop()
        rc = stack.stop()
    _check("s3 stack exit code after SIGTERM", rc, 0)
    numbers = {
        "lost": {"vid": vid, "sid": sid, "objects": n_cross,
                 "wide_objects": n_wide},
        "replicate": {"objects": len(want), "bytes": rep_bytes,
                      "s": round(rep_s, 3),
                      "mb_s": round(rep_bytes / rep_s / 1e6, 1),
                      "notified": notified},
        "webdav_get_mb_s": round(dav_bytes / dav_s / 1e6, 1),
        "webdav_get_p50_ms": round(_pct(dav_lat, 0.5), 3),
        "webdav_get_p99_ms": round(_pct(dav_lat, 0.99), 3),
        "shell_s": round(shell_s, 3),
        "events": len(events), "broker_messages": len(msgs),
        "watch_lines": len(watch_lines), "catch_up_s": round(lag_s, 3),
        "k1_launches": launches, "device_dispatches": dispatches,
        "wall_s": round(time.perf_counter() - t_step, 3)}
    print(card_line())
    print("events step: " + json.dumps(numbers))
    return numbers


def make_pki(d):
    """Step 21 (a): a CA, a server and a peer certificate it signed, and a
    self-signed rogue one, by the openssl CLI; {name: (cert, key)} and
    the CA's path. A missing openssl raises."""
    def run(*cmd):
        out = subprocess.run(cmd, capture_output=True, timeout=120)
        if out.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[:3])}: {out.stderr[-300:]}")
    ca, cakey = os.path.join(d, "ca.pem"), os.path.join(d, "ca.key")
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", cakey, "-out", ca, "-days", "1", "-subj", "/CN=smoke-ca")
    pairs = {}
    for name, cn in (("srv", "127.0.0.1"), ("peer", "peer")):
        key, csr, crt = (os.path.join(d, f"{name}.{x}")
                         for x in ("key", "csr", "pem"))
        run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout",
            key, "-out", csr, "-subj", f"/CN={cn}")
        run("openssl", "x509", "-req", "-in", csr, "-CA", ca, "-CAkey",
            cakey, "-CAcreateserial", "-out", crt, "-days", "1")
        pairs[name] = (crt, key)
    rcrt, rkey = os.path.join(d, "rogue.pem"), os.path.join(d, "rogue.key")
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", rkey, "-out", rcrt, "-days", "1", "-subj", "/CN=rogue")
    pairs["rogue"] = (rcrt, rkey)
    return ca, pairs


class MtlsCluster:
    """Step 21's cluster as an operator starts it: ``command.cli server
    -filer`` in a directory that holds only security.toml and
    master.toml (its TLS, write-token key and growth come from them), and
    two ``command.cli volume`` processes given the same material by
    flags (``b`` on the compact needle map, ``c`` on the sorted-file
    one), on free ports, every volume server on the card. ``spawn``
    makes the certificates and starts the three on a thread of its own
    (the caller goes on), ``wait`` joins it and reads their addresses,
    ``stop`` sends SIGTERM and wants exit code 0 of each."""

    def __init__(self, work):
        self.dir = os.path.join(work, "mtls")
        self.cfg = os.path.join(self.dir, "cfg")
        os.makedirs(self.cfg)
        ports = _free_ports(5)
        self.master, self.a, self.filer, self.b, self.c = (
            f"127.0.0.1:{p}" for p in ports)
        self.ports = ports
        self.procs, self.lines = {}, {}
        self._spawning, self._spawn_error = None, None

    def spawn(self):
        self._spawning = threading.Thread(target=self._spawn, daemon=True)
        self._spawning.start()
        return self

    def _spawn(self):
        try:
            self._make_and_start()
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._spawn_error = e

    def _make_and_start(self):
        t0 = time.perf_counter()
        self.ca, self.pairs = make_pki(self.dir)
        self.pki_s = time.perf_counter() - t0
        cert, key = self.pairs["srv"]
        with open(os.path.join(self.cfg, "security.toml"), "w") as f:
            f.write(f'[jwt.signing]\nkey = "{MTLS_JWT}"\n\n[https]\n'
                    f'cert = "{cert}"\nkey = "{key}"\nca = "{self.ca}"\n'
                    f'mutual = true\n')
        with open(os.path.join(self.cfg, "master.toml"), "w") as f:
            f.write(f'[master.maintenance]\nscripts = ""\n\n'
                    f'[master.volume_growth]\ncopy_1 = {MTLS_GROWTH}\n')
        mport, aport, fport, bport, cport = self.ports
        env = dict(os.environ, SW_REPAIR_INTERVAL_S="0", PYTHONPATH=ROOT)
        cli = [sys.executable, "-m", "seaweedfs_tpu_torch.command.cli"]
        self._start("server", self.cfg, cli + [
            "server", "-filer", "-ec.backend", "cuda",
            "-dataCenter", MTLS_DC["a"],
            "-dir", os.path.join(self.dir, "a"), "-max", "64",
            "-masterPort", str(mport), "-port", str(aport),
            "-filerPort", str(fport), "-pulseSeconds", "1"], env)
        for name, port in (("b", bport), ("c", cport)):
            d = os.path.join(self.dir, name)
            os.makedirs(d)
            self._start(name, d, cli + [
                "volume", "-ec.backend", "cuda", "-index", MTLS_INDEX[name],
                "-dataCenter", MTLS_DC[name], "-dir", d, "-max", "64",
                "-port", str(port), "-mserver", self.master,
                "-pulseSeconds", "1", "-jwtKey", MTLS_JWT,
                "-tlsCert", cert, "-tlsKey", key, "-tlsCa", self.ca,
                "-tlsMutual"], env)

    def _start(self, name, cwd, argv, env):
        proc = subprocess.Popen(
            argv, cwd=cwd, stdout=subprocess.PIPE, text=True, env=env,
            stderr=open(os.path.join(self.dir, f"{name}.log"), "wb"))
        self.procs[name] = proc
        self.lines[name] = queue.Queue()
        threading.Thread(target=self._read, args=(proc.stdout,
                                                  self.lines[name]),
                         daemon=True).start()

    @staticmethod
    def _read(out, q):
        for line in out:
            q.put(line.strip())
        q.put(None)

    def _until(self, name, prefix, deadline):
        lines = []
        while time.monotonic() < deadline:
            try:
                line = self.lines[name].get(timeout=0.5)
            except queue.Empty:
                continue
            if line is None:
                break
            lines.append(line)
            if line.startswith(prefix):
                return lines
        with open(os.path.join(self.dir, f"{name}.log"), "rb") as f:
            err = f.read()[-2000:].decode("utf-8", "replace")
        raise AssertionError(f"mtls {name} did not start (exit "
                             f"{self.procs[name].poll()}): {lines} {err}")

    def wait(self):
        deadline = time.monotonic() + HOLDER_START_S
        self._spawning.join(HOLDER_START_S)
        if self._spawn_error is not None:
            raise self._spawn_error
        out = {"server": self._until("server", "filer on", deadline)}
        for name in ("b", "c"):
            out[name] = self._until(name, "volume server listening on",
                                    deadline)
        want = {"server": [f"master on {self.master}, volume server on "
                           f"{self.a}", f"filer on {self.filer}"],
                "b": [f"volume server listening on {self.b}, heartbeating "
                      f"to {self.master}"],
                "c": [f"volume server listening on {self.c}, heartbeating "
                      f"to {self.master}"]}
        _check("mtls cluster's lines (no native plane)", out, want)
        return out

    def stop(self):
        """SIGTERM to each; their exit codes."""
        if self._spawning is not None:
            self._spawning.join(HOLDER_START_S)
        procs, self.procs = self.procs, {}
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        rcs = {}
        for name, proc in procs.items():
            try:
                rcs[name] = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[name] = proc.wait()
        return rcs

    stop_processes = stop

    def cli(self, *argv, timeout=300):
        """One ``command.cli`` process in the config directory (TLS and
        the write-token key from its security.toml); its stdout."""
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch.command.cli",
             *argv], cwd=self.cfg, capture_output=True, text=True,
            timeout=timeout, env=dict(os.environ, PYTHONPATH=ROOT))
        if out.returncode != 0:
            raise AssertionError(f"cli {argv[0]}: exit {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        return out.stdout, time.perf_counter() - t0


def _https_status(hostport, path, ca, cert=None):
    """(status, body) of one GET over a TLS connection of its own: the
    CA trusted, ``cert`` presented when given."""
    import http.client
    import ssl
    ctx = ssl.create_default_context(cafile=ca)
    ctx.check_hostname = False
    if cert:
        ctx.load_cert_chain(*cert)
    host, port = hostport.rsplit(":", 1)
    c = http.client.HTTPSConnection(host, int(port), timeout=30,
                                    context=ctx)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _refused(what, fn):
    """``fn`` must fail at the transport: no HTTP answer."""
    import http.client
    try:
        fn()
    except (OSError, http.client.HTTPException):
        return
    raise AssertionError(f"{what}: answered")


def _bench_report(text):
    """{phase: {ok, failed, wall_s, req_s, kb_s, p50_ms, p99_ms}} of a
    benchmark's report."""
    import re as _re
    out = {}
    for title, body in _re.findall(r"--- (write|random read) ---\n"
                                   r"(.*?)(?=\n\n|\Z)", text, _re.S):
        m = _re.search(r"requests: (\d+) ok, (\d+) failed in ([\d.]+)s",
                       body)
        t = _re.search(r"throughput: ([\d.]+) req/s, ([\d.]+) KB/s", body)
        p = dict(_re.findall(r"p(\d+): ([\d.]+) ms", body))
        out[title] = {"ok": int(m.group(1)), "failed": int(m.group(2)),
                      "wall_s": float(m.group(3)),
                      "req_s": float(t.group(1)),
                      "mb_s": round(float(t.group(2)) * 1024 / 1e6, 3),
                      "p50_ms": float(p["50"]), "p99_ms": float(p["99"])}
    return out


def _mtls_plan(np, seed):
    """MTLS_FILES (name, bytes), log-uniform sizes scaled to about
    MTLS_BYTES, and a small tree for filer.copy: [(relative path,
    bytes)]."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(MTLS_MIN), np.log(MTLS_MAX),
                               MTLS_FILES))
    sizes = np.clip(sizes * MTLS_BYTES / sizes.sum(), MTLS_MIN,
                    MTLS_MAX).astype(int)
    files = [(f"f{i:02d}.bin", rng.bytes(int(n)))
             for i, n in enumerate(sizes)]
    tree = [(f"logs/d{i % 2}/part-{i}.txt", rng.bytes(int(n)))
            for i, n in enumerate(rng.integers(1 << 10, 256 << 10, 6))]
    return files, tree


def _k1_by_server(urls):
    return {u: _devices_k1(u) for u in urls}


def _engines(urls):
    from seaweedfs_tpu_torch.server.http_util import get_json
    return {u: get_json(f"http://{u}/status")["ec_degraded"] for u in urls}


def _metric_sum(url, name, label):
    """The sum of ``name``'s samples whose labels hold ``label``, from
    ``url``'s /metrics."""
    from seaweedfs_tpu_torch.server.http_util import http_call
    total = 0.0
    for line in http_call("GET", f"http://{url}/metrics").decode() \
            .splitlines():
        if line.startswith(name) and label in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


def _collection_vids(d, collection):
    """The volume ids of ``collection`` whose .dat lies in ``d``."""
    return sorted(int(n[len(collection) + 1:-4]) for n in os.listdir(d)
                  if n.startswith(collection + "_") and n.endswith(".dat"))


def _grow_one_each(m, dirs):
    """Step 21: one MTLS_COLLECTION volume grown in each server's data
    center (MTLS_DC), before anything is written to the collection, so
    the benchmark and the uploads find MTLS_GROWTH writable volumes, one
    on each server, and grow none at random."""
    from seaweedfs_tpu_torch.server.http_util import post_json
    for dc in MTLS_DC.values():
        got = post_json(f"http://{m}/vol/grow?collection={MTLS_COLLECTION}"
                        f"&count=1&dataCenter={dc}", {})
        _check(f"a {MTLS_COLLECTION} volume grown in {dc}", got["count"], 1)
    _check(f"one {MTLS_COLLECTION} volume on each server",
           [len(_collection_vids(d, MTLS_COLLECTION))
            for d in dirs.values()], [1] * len(dirs))


def _move_to_sorted_holder(cluster, d, fids):
    """Step 21: the volume that the most uploaded files sit on among
    those off the sorted-file holder ``c`` (over ``d``) moved onto it by
    weed shell's volume.move (a process), so the downloads read through
    c's mapped .sdx. Returns the moved volume id."""
    from collections import Counter
    on = Counter(int(fid.split(",")[0]) for fid in fids.values())
    held = set(_collection_vids(d, MTLS_COLLECTION))
    vid = next((v for v, _ in on.most_common() if v not in held), None)
    if vid is None:
        raise AssertionError(f"every uploaded file sits on {cluster.c}")
    out, _ = cluster.cli("shell", "-master", cluster.master, "-c",
                         f"volume.move -volumeId {vid} -target {cluster.c}")
    if vid not in _collection_vids(d, MTLS_COLLECTION):
        raise AssertionError(f"volume.move {vid} to {cluster.c}: {out}")
    return vid


def _remount_sorted(url, d):
    """Every volume of the sorted-file holder ``url`` (over ``d``)
    unmounted and mounted again, so that its needle map loads the .idx
    into a .sdx whose .sdx.meta watermark covers the whole .idx (the
    reads after go through the mapped file). Returns {volume: .sdx
    bytes}."""
    out = {}
    for name in sorted(n[:-4] for n in os.listdir(d) if n.endswith(".dat")):
        vid = int(name.rsplit("_", 1)[-1])
        _post(url, f"/admin/volume/unmount?volume={vid}")
        _post(url, f"/admin/volume/mount?volume={vid}")
        prefix = os.path.join(d, name)
        if not all(os.path.exists(prefix + ext)
                   for ext in (".sdx", ".sdx.meta")):
            raise AssertionError(f"{url}: volume {name} has no .sdx and "
                                 f".sdx.meta")
        with open(prefix + ".sdx.meta") as f:
            meta = json.load(f)
        out[name] = os.path.getsize(prefix + ".sdx")
        if meta["idx_size"] != os.path.getsize(prefix + ".idx") or \
                out[name] % 16:
            raise AssertionError(f"{url}: volume {name}'s .sdx "
                                 f"({out[name]} B) and watermark {meta} "
                                 f"against its .idx")
    return out


def mtls_leg(np, port, work, seed, cluster):
    """Step 21: a mutual-TLS cluster configured by its files, loaded by
    the operator commands, read through a lost shard reconstructed on K1
    in the holders' processes, and rebuilt."""
    import argparse
    import contextlib
    import io
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
    from seaweedfs_tpu_torch.server import http_util
    from seaweedfs_tpu_torch.storage.types import parse_file_id
    ec = port[0]
    t_step = time.perf_counter()
    started = cluster.wait()
    print(f"mtls cluster (certificates in {cluster.pki_s:.2f} s): " + "; ".join(
        ln for lines in started.values() for ln in lines))
    m, f, ca = cluster.master, cluster.filer, cluster.ca
    servers = (cluster.a, cluster.b, cluster.c)
    dirs = {cluster.a: os.path.join(cluster.dir, "a"),
            cluster.b: os.path.join(cluster.dir, "b"),
            cluster.c: os.path.join(cluster.dir, "c")}
    peer, rogue = cluster.pairs["peer"], cluster.pairs["rogue"]
    http_util.configure_tls(*peer, ca)
    try:
        _wait_for("three volume servers registered", lambda: sorted(
            n["url"] for n in http_util.get_json(
                f"http://{m}/cluster/status")["nodes"]) == sorted(servers),
            HOLDER_START_S)
        t_up = time.perf_counter()
        # (c) refusals
        import http.client
        plain = http.client.HTTPConnection(*m.split(":"), timeout=10)
        _refused("plain http:// to the master", lambda: (
            plain.request("GET", "/dir/status"),
            plain.getresponse().read()))
        plain.close()
        refusals = {}
        for what, url, path in (("master /cluster/status", m,
                                 "/cluster/status"),
                                *((f"{u} /admin/devices", u,
                                   "/admin/devices") for u in servers)):
            st, body = _https_status(url, path, ca)
            _check(f"{what} without a client certificate",
                   (st, b"certificate" in body), (403, True))
            refusals[what] = st
        _check("master /cluster/status with the peer certificate",
               _https_status(m, "/cluster/status", ca, peer)[0], 200)
        _refused("the rogue certificate", lambda: _https_status(
            m, "/cluster/status", ca, rogue))
        for u in servers:
            _check(f"{u} runs no native plane",
                   "fast_plane" in http_util.get_json(f"http://{u}/status"),
                   False)

        # (d) the operator commands, each a process in the config dir
        _grow_one_each(m, dirs)
        bench_out, bench_s = cluster.cli(
            "benchmark", "-master", m, "-n", str(MTLS_BENCH_N), "-size",
            str(MTLS_BENCH_SIZE), "-c", "8", "-collection", MTLS_COLLECTION)
        bench = _bench_report(bench_out)
        for phase in ("write", "random read"):
            _check(f"benchmark {phase}",
                   (bench[phase]["ok"], bench[phase]["failed"]),
                   (MTLS_BENCH_N, 0))
        files, tree = _mtls_plan(np, seed)
        fdir = os.path.join(cluster.dir, "files")
        os.makedirs(fdir)
        want = {}
        for name, data in files:
            with open(os.path.join(fdir, name), "wb") as fh:
                fh.write(data)
            want[name] = hashlib.sha256(data).hexdigest()
        up_out, up_s = cluster.cli(
            "upload", "-master", m, "-collection", MTLS_COLLECTION,
            *(os.path.join(fdir, n) for n, _ in files))
        fids = {os.path.basename(ln.split(" -> ")[0]): ln.split(" -> ")[1]
                for ln in up_out.splitlines()}
        _check("uploaded files", sorted(fids), sorted(want))
        a0 = http_util.get_json(f"http://{m}/dir/lookup?volumeId="
                                f"{fids[files[0][0]].split(',')[0]}")
        _check("public fid GET over server TLS", _https_status(
            a0["locations"][0]["url"], "/" + fids[files[0][0]], ca)[0], 200)
        tdir = os.path.join(cluster.dir, "tree")
        for rel, data in tree:
            os.makedirs(os.path.dirname(os.path.join(tdir, rel)),
                        exist_ok=True)
            with open(os.path.join(tdir, rel), "wb") as fh:
                fh.write(data)
        copy_out, copy_s = cluster.cli("filer.copy", "-c", "4", tdir,
                                       f"http://{f}/copied/")
        _check("filer.copy", copy_out.splitlines()[-1],
               f"copied {len(tree)} files to {f}/copied")
        for sub in sorted({os.path.dirname(rel) for rel, _ in tree}):
            page = http_util.http_call(
                "GET", f"http://{f}/copied/tree/{sub}/",
                headers={"Accept": "text/html"}).decode()
            for rel, data in tree:
                if os.path.dirname(rel) == sub:
                    _check(f"filer listing names {rel}",
                           f">{os.path.basename(rel)}</a>" in page, True)
                    _check(f"filer GET {rel}", http_util.http_call(
                        "GET", f"http://{f}/copied/tree/{rel}"), data)
        moved = _move_to_sorted_holder(cluster, dirs[cluster.c], fids)
        mpage = http_util.http_call("GET", f"http://{m}/ui").decode()
        _check("master /ui names the volume servers",
               [u in mpage for u in servers], [True] * 3)
        import re as _re
        listed = {}
        for u in servers:
            page = http_util.http_call("GET", f"http://{u}/ui").decode()
            rows = _re.search(r"<h2>Volumes</h2>(.*?)</table>", page).group(1)
            listed[u] = sorted(
                (f"{c}_{v}" if c != "-" else v) for v, c in _re.findall(
                    r"<tr><td>(\d+)</td><td>([^<]*)</td>", rows))
            _check(f"{u} /ui lists its volumes", listed[u], sorted(
                n[:-4] for n in os.listdir(dirs[u]) if n.endswith(".dat")))
        _check(f"the {MTLS_COLLECTION} volumes on the /ui pages", sum(
            n.startswith(MTLS_COLLECTION + "_") for v in listed.values()
            for n in v), MTLS_GROWTH)

        sdx = _remount_sorted(cluster.c, dirs[cluster.c])
        out_dir = os.path.join(cluster.dir, "out")

        def download_pass(label):
            """Every file through the CLI's download, one call a file:
            (ms list, MB/s, the client pool's created and reused)."""
            pool0 = http_util.pool_stats_snapshot()
            lat, t0 = [], time.perf_counter()
            for name, fid in fids.items():
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.cmd_download(argparse.Namespace(
                        master=m, dir=out_dir, fids=[fid]))
                lat.append((time.perf_counter() - t) * 1e3)
                with open(os.path.join(out_dir, name), "rb") as fh:
                    got = hashlib.sha256(fh.read()).hexdigest()
                if got != want[name]:
                    raise AssertionError(f"mtls {label} download {name}")
            wall = time.perf_counter() - t0
            pool1 = http_util.pool_stats_snapshot()
            return lat, sum(len(d) for _, d in files) / wall / 1e6, {
                k: pool1[k] - pool0[k] for k in ("created", "reused")}
        healthy = download_pass("healthy")

        # (e) encode through weed shell, lose the busiest shard
        k_enc0 = _k1_by_server(servers)
        enc_out, encode_s = cluster.cli(
            "shell", "-master", m, "-c",
            f"ec.encode -collection {MTLS_COLLECTION} -fullPercent 0 "
            f"-quietFor 0")
        print("  shell> ec.encode\n" + "".join(
            f"    {ln}\n" for ln in enc_out.splitlines()), end="")
        if "error:" in enc_out or "falling back" in enc_out:
            raise AssertionError(f"ec.encode: {enc_out}")
        k_enc1 = _k1_by_server(servers)
        k_enc = sum(k_enc1.values()) - sum(k_enc0.values())
        # the sorted-file holder's encoded volumes left no sidecar
        cdir = dirs[cluster.c]
        encoded = [n for n in sdx if n.startswith(MTLS_COLLECTION + "_")
                   and not os.path.exists(os.path.join(cdir, n + ".dat"))]
        left = [n + ext for n in encoded for ext in (".sdx", ".sdx.meta")
                if os.path.exists(os.path.join(cdir, n + ext))]
        if not encoded or left:
            raise AssertionError(f"mtls: encoded on {cluster.c} {encoded}, "
                                 f"sidecars left {left}")
        crossing, vols = {}, {}
        try:
            for name, fid in fids.items():
                vid, nid, _ = parse_file_id(fid)
                if vid not in vols:
                    d = next(d for d in dirs.values() if os.path.exists(
                        os.path.join(d, f"{MTLS_COLLECTION}_{vid}.ecx")))
                    vols[vid] = EcVolume(d, MTLS_COLLECTION, vid)
                by_sid = {}
                for iv in vols[vid].locate_needle(nid)[2]:
                    sid = iv.to_shard_id_and_offset(
                        ec.LARGE_BLOCK_SIZE, ec.SMALL_BLOCK_SIZE)[0]
                    by_sid[sid] = by_sid.get(sid, 0) + iv.size
                for sid, nbytes in by_sid.items():
                    n, wide = crossing.get((vid, sid), (0, 0))
                    crossing[(vid, sid)] = (n + 1,
                                            wide + (nbytes >= MTLS_MIN))
        finally:
            for v in vols.values():
                v.close()
        (vid, sid), (n_cross, n_wide) = max(
            crossing.items(), key=lambda kv: (kv[1][1], kv[1][0], kv[0]))
        shard_name = f"{MTLS_COLLECTION}_{vid}{ec.to_ext(sid)}"
        holder = next(u for u, d in dirs.items()
                      if os.path.exists(os.path.join(d, shard_name)))
        lost_sha = _sha(os.path.join(dirs[holder], shard_name))
        os.remove(os.path.join(dirs[holder], shard_name))
        _post(holder, f"/admin/ec/unmount?volume={vid}&shards={sid}")

        def snap():
            return (_k1_by_server(servers), _engines(servers),
                    {u: _metric_sum(u, "SeaweedFS_volumeServer_request_total",
                                    "GET /admin/ec/shard_read")
                     for u in servers},
                    {u: {ev: _metric_sum(
                        u, "SeaweedFS_volumeServer_http_pool_churn_total",
                        f'event="{ev}"') for ev in ("created", "reused")}
                     for u in servers})
        k0, e0, r0, c0 = snap()
        cold = download_pass("cold")
        k1, e1, r1, c1 = snap()
        warm = download_pass("warm")
        k2, e2, _, _ = snap()
        cold_launches = sum(k1.values()) - sum(k0.values())
        dev = sum(e1[u]["device_dispatches"] - e0[u]["device_dispatches"]
                  for u in servers)
        remote = sum(e1[u]["remote_bytes"] - e0[u]["remote_bytes"]
                     for u in servers)
        pulls = sum(r1.values()) - sum(r0.values())
        if cold_launches < 1 or cold_launches != dev or remote < 1 or \
                pulls < 1:
            raise AssertionError(
                f"mtls cold pass: {cold_launches} K1 launches, {dev} device "
                f"dispatches, {remote} remote bytes, {pulls} shard_read "
                f"pulls; engines {e0} -> {e1}")

        # (f) rebuild through weed shell
        reb_out, rebuild_s = cluster.cli(
            "shell", "-master", m, "-c",
            f"ec.rebuild -collection {MTLS_COLLECTION}")
        print("  shell> ec.rebuild\n" + "".join(
            f"    {ln}\n" for ln in reb_out.splitlines()), end="")
        k3 = _k1_by_server(servers)
        rebuild_launches = sum(k3.values()) - sum(k2.values())
        rebuilt = [os.path.join(d, shard_name) for d in dirs.values()
                   if os.path.exists(os.path.join(d, shard_name))]
        _check("rebuilt shard", [_sha(p) for p in rebuilt], [lost_sha])
        if rebuild_launches < 1:
            raise AssertionError(f"ec.rebuild: {rebuild_launches} K1 "
                                 f"launches")
        after = download_pass("rebuilt")
        k4 = _k1_by_server(servers)
        step_s = time.perf_counter() - t_up
    finally:
        http_util.reset_tls()
        rcs = cluster.stop()
    _check("mtls cluster exit codes after SIGTERM", rcs,
           {"server": 0, "b": 0, "c": 0})

    def lat(x):
        return {"mb_s": round(x[1], 1), "p50_ms": round(_pct(x[0], 0.5), 3),
                "p99_ms": round(_pct(x[0], 0.99), 3)}
    numbers = {
        "benchmark": bench, "benchmark_process_s": round(bench_s, 3),
        "upload_mb_s": round(sum(len(d) for _, d in files) / up_s / 1e6, 1),
        "upload_process_s": round(up_s, 3),
        "filer_copy_process_s": round(copy_s, 3),
        "files": len(files), "bytes": sum(len(d) for _, d in files),
        "download": {"healthy": lat(healthy), "cold": lat(cold),
                     "warm": lat(warm), "rebuilt": lat(after)},
        "lost": {"vid": vid, "sid": sid, "files": n_cross,
                 "wide_files": n_wide, "holder": holder},
        "k1_launches": {"encode": k_enc, "cold": cold_launches,
                        "warm": sum(k2.values()) - sum(k1.values()),
                        "rebuild": rebuild_launches,
                        "rebuilt": sum(k4.values()) - sum(k3.values()),
                        "by_server_cold": {u: k1[u] - k0[u]
                                           for u in servers}},
        "cold_remote_bytes": remote, "cold_shard_read_pulls": pulls,
        "pool_connections": {
            "smoke_client": {"healthy": healthy[2], "cold": cold[2],
                             "warm": warm[2]},
            "holders_cold": {u: {ev: c1[u][ev] - c0[u][ev]
                                 for ev in c1[u]} for u in servers},
            "holders_total": c1},
        "refusals": refusals,
        "index": {"b": MTLS_INDEX["b"], "c": MTLS_INDEX["c"],
                  "c_sdx_bytes": sdx, "c_encoded": encoded,
                  "moved_to_c": moved},
        "encode_s": round(encode_s, 3), "rebuild_s": round(rebuild_s, 3),
        "step_s_after_start": round(step_s, 3),
        "wall_s": round(time.perf_counter() - t_step, 3)}
    numbers["k1_launches"]["step"] = sum(
        v for k, v in numbers["k1_launches"].items() if k != "by_server_cold")
    b_w, b_r = bench["write"], bench["random read"]
    print(f"mtls (c): plain http refused, 403 without a client certificate "
          f"({len(refusals)} routes), the rogue certificate refused in the "
          f"handshake, fid GET 200 over server TLS, no native plane")
    print(f"mtls (d): benchmark over TLS: write {b_w['req_s']} req/s "
          f"{b_w['mb_s']} MB/s p50 {b_w['p50_ms']} ms p99 {b_w['p99_ms']} "
          f"ms; read {b_r['req_s']} req/s {b_r['mb_s']} MB/s p50 "
          f"{b_r['p50_ms']} ms p99 {b_r['p99_ms']} ms; upload of "
          f"{len(files)} files in {up_s:.2f} s (process); filer.copy of "
          f"{len(tree)} in {copy_s:.2f} s; downloads healthy "
          f"{numbers['download']['healthy']}")
    print(f"mtls (d): b on the {MTLS_INDEX['b']} needle map, c on the "
          f"{MTLS_INDEX['c']} one, its volumes remounted onto a .sdx each "
          f"({sum(sdx.values())} B: {json.dumps(sdx)}; moved there by "
          f"volume.move: {moved}), the watermarks covering "
          f"their .idx; after ec.encode no .sdx or .sdx.meta of "
          f"{encoded} left")
    print(f"mtls (e): ec.encode in {encode_s:.2f} s ({k_enc} K1 launches);"
          f" lost shard {sid} of volume {vid} on {holder}, crossed by "
          f"{n_cross} files ({n_wide} by >= {MTLS_MIN} B); cold "
          f"{numbers['download']['cold']}, {cold_launches} K1 launches = "
          f"the engines' device dispatches, {remote} B pulled over "
          f"{pulls} mutual-TLS shard reads; warm "
          f"{numbers['download']['warm']}, "
          f"{numbers['k1_launches']['warm']} launches; connections opened "
          f"(reused) by the holders' pools over the cold pass "
          f"{numbers['pool_connections']['holders_cold']}, by this "
          f"client's {cold[2]}")
    print(f"mtls (f): ec.rebuild in {rebuild_s:.2f} s ({rebuild_launches} "
          f"K1 launches), shard sha256-identical; downloads "
          f"{numbers['download']['rebuilt']}")
    print(card_line())
    print("mtls step: " + json.dumps(numbers))
    return numbers


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from seaweedfs_tpu_torch import ec, ops, storage
    from seaweedfs_tpu_torch.ops import (codec as ops_codec, device_stats,
                                         gf256, gf_plan, rs_bitplane,
                                         rs_hopper, rs_native, telemetry)
    from seaweedfs_tpu_torch.ops.codec import NumpyCodec
    from seaweedfs_tpu_torch.parallel import sharded_ec
    from seaweedfs_tpu_torch.server import native_plane
    from seaweedfs_tpu_torch.storage import crc
    from seaweedfs_tpu_torch.tools import kernel_exp

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t_run = time.perf_counter()

    def phase(name):
        print(f"phase {name} done at {time.perf_counter() - t_run:.2f} s")

    def timed_host(fn, *fn_args):
        t0 = time.perf_counter()
        return fn(*fn_args), time.perf_counter() - t0
    # the host's plans are built while the compilers run
    with ThreadPoolExecutor(max_workers=2) as host:
        pb_plans = host.submit(timed_host, piggyback_geometries, ops_codec)
        repair_plans = host.submit(timed_host, repair_targets, np,
                                   ops_codec, args.seed)
        build_s = build_kernels((rs_hopper, rs_bitplane), crc, native_plane,
                                rs_native)
        pb_geos, pb_s = pb_plans.result()
        (trace_plan, plane_plan), repair_s = repair_plans.result()
    sass_counts(rs_bitplane.LIBRARY)
    phase("builds")
    print(f"piggyback plans (RS(10,4), two decodes, RS(20,4)) built on the "
          f"host in {pb_s:.2f} s, beside the builds")
    flat_geos = geometries(np, gf256, NumpyCodec, args.seed)
    max_err = check_kernel(torch, np, rs_hopper, gf_plan, flat_geos, dev,
                           args.seed, misaligned=MAIN_N)
    pb_k1_err = check_kernel(
        torch, np, rs_hopper, gf_plan,
        [(label, c, widths + (MAIN_N, MAIN_N + 1))
         for label, c, widths in pb_geos], dev, args.seed + 3)
    print(f"repair plans built on the host in {repair_s:.2f} s, beside the "
          f"builds: trace lost {trace_plan.lost} ({trace_plan.total_bits} bits "
          f"from {len(trace_plan.helpers)} helpers, {trace_plan.frac} of "
          f"k x shard), plane lost {plane_plan.lost} "
          f"{plane_plan.matrix.shape} ({plane_plan.frac} of k x shard)")
    repair_err = max(
        check_kernel(torch, np, rs_hopper, gf_plan, [geo], dev,
                     args.seed + 5, misaligned=geo[2][3])
        for geo in repair_geometries(trace_plan, plane_plan))
    t0 = time.perf_counter()
    degraded_lost, read_geos = degraded_targets(np, ops_codec, NumpyCodec,
                                                args.seed)
    print(f"degraded-read and scrub plans built on the host in "
          f"{time.perf_counter() - t0:.2f} s: lost data shard "
          f"{degraded_lost}, " + ", ".join(
              f"{label} {c.shape}" for label, c, _ in read_geos))
    read_err = {label: check_kernel(torch, np, rs_hopper, gf_plan,
                                    [(label, c, widths)], dev, args.seed + 7,
                                    misaligned=widths[3])
                for label, c, widths in read_geos}
    (_, flat_row, _), (_, pb_rows, _), (_, syn, _), (_, pb_syn, _) = \
        read_geos
    mesh_geos = mesh_geometries(sharded_ec)
    mesh_err = check_kernel(torch, np, rs_hopper, gf_plan, mesh_geos, dev,
                            args.seed + 9, misaligned=MESH_LANE_N)
    phase("K1 against its plain version")
    timed = time_kernel(torch, rs_hopper, gf_plan, kernel_exp,
                        timed_shapes(np, gf256, NumpyCodec, ops_codec)
                        + [("trace combine", trace_plan.combine, TRACE_N),
                           ("plane repair", plane_plan.matrix, PB_N),
                           ("degraded flat wide", flat_row, WIDE_N),
                           ("degraded flat needle batch", flat_row, NEEDLE_N),
                           ("degraded piggyback wide", pb_rows, PB_WIDE_N),
                           ("scrub flat", syn, SCRUB_N),
                           ("scrub piggyback", pb_syn, PB_SCRUB_N),
                           ("mesh lane encode", mesh_geos[0][1], MESH_LANE_N),
                           ("mesh rebuild partial", mesh_geos[1][1],
                            MESH_STEP_N)],
                        dev, args.seed)
    phase("K1 timed")
    geos = [(label, c, BP_WIDTHS + ((MAIN_N,) if c.shape[0] <= 4 else ()))
            for label, c, _ in flat_geos]
    bp_err = check_bitplane(torch, np, rs_bitplane, rs_hopper, gf_plan, geos,
                            dev, args.seed, misaligned=True)
    pb_err = check_bitplane(torch, np, rs_bitplane, rs_hopper, gf_plan,
                            pb_geos, dev, args.seed + 1)
    bp_err = {name: max(bp_err[name], pb_err[name]) for name in bp_err}
    phase("bit-plane kernels against their plain versions")
    exp_flat, exp_pb, bp_launches = kernel_exp_phase(
        torch, kernel_exp, rs_bitplane, gf256, ops_codec, dev, args.seed)
    phase("kernel_exp")

    work = os.path.join(str(rs_hopper.BUILD_DIR), "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    base = os.path.join(work, "1")
    port = (ec, ops, storage)
    legs, walls = {}, {}

    def drive(name, fn, *fn_args, kernel=True, per_dispatch=1, extra=0):
        """One leg of the main path, every kernel's launches (this
        process's ops/device_stats launches) set to 0 just before it
        and read just after; K1's must equal the leg's dispatches (times
        ``per_dispatch``, the mesh positions of a sharded one, plus
        ``extra``, the launches of programs that count no dispatch), and
        a kernel leg must launch. Prints the leg's wall."""
        t0 = time.perf_counter()
        device_stats.DEVICE_STATS.reset_counts()
        before = telemetry.STATS.snapshot()
        out = fn(*fn_args)
        launches = _k1()
        dispatches = telemetry.delta(before)["dispatches"]
        if launches != per_dispatch * dispatches + extra or \
                (kernel and launches < 1):
            raise AssertionError(f"{name}: {launches} kernel launches for "
                                 f"{dispatches} dispatches")
        legs[name] = launches
        walls[name] = round(time.perf_counter() - t0, 3)
        print(f"leg {name}: {walls[name]} s, {launches} K1 launches")
        return out

    t_path = time.perf_counter()
    spreading = []
    try:
        res = drive("flat", main_path, torch, np, port, dev, base,
                    VOLUME_BYTES, args.seed)
        host_codec = drive("native codec", native_leg, np, port, dev, work,
                           base, res, timed["flat encode"], kernel=False)
        drive("traced", trace_main_path, torch, port, dev, base, res["shas"])
        drive("trace repair", trace_repair_leg, np, port, dev, base, res,
              trace_plan)
        drive("streaming", streaming_leg, np, port, dev, base, res,
              args.seed)
        drive("degraded flat", degraded_leg, np, port, dev, base, res,
              degraded_lost, args.seed + 41, "degraded flat")
        drive("scrub flat", scrub_leg, np, port, dev, base, res, res["shas"],
              args.seed + 43, "scrub flat")
        tuner = drive("tuner", tuner_leg, np, port, args.seed + 45)
        # each spread leg's holders start with the net legs' before it,
        # so that one wait covers both groups' start-up
        spreading.append(spread_holders(ec, work, base, "flat"))
        holders = Holders(base, work, "flat", ec.TOTAL_SHARDS)
        try:
            holders.start()
            drive("net trace repair", net_trace_leg, np, port, holders, work,
                  res, trace_plan)
            drive("net full rebuild", net_full_leg, np, port, holders, work,
                  res, args.seed)
            drive("net degraded flat", net_degraded_leg, np, port, dev,
                  holders, work, base, res, args.seed + 41,
                  "net degraded flat")
            drive("net scrub flat", net_scrub_leg, np, port, dev, holders,
                  base, res, args.seed + 59, "net scrub flat")
        finally:
            holders.stop()
        t0 = time.perf_counter()
        dat = {"size": os.path.getsize(base + ".dat"),
               "sha": _sha(base + ".dat")}
        print(f"the .dat's sha256 for the spread legs in "
              f"{time.perf_counter() - t0:.2f} s")
        drive("spread flat", spread_leg, torch, port, work, base, res,
              res["shas"], dat, "flat", spreading[0])
        pb = drive("piggyback", piggyback_leg, np, port, dev, base, res,
                   args.seed)
        drive("plane repair", plane_repair_leg, np, port, dev, base, res, pb,
              plane_plan)
        drive("streaming piggyback", streaming_piggyback_leg, np, port, dev,
              base, res, pb, args.seed)
        drive("degraded piggyback", degraded_leg, np, port, dev, base, res,
              degraded_lost, args.seed + 47, "degraded piggyback",
              PB_DEGRADED_GETS)
        drive("scrub piggyback", scrub_leg, np, port, dev, base, res,
              pb["shas"], args.seed + 53, "scrub piggyback")
        spreading.append(spread_holders(ec, work, base, "piggyback"))
        # step 15's master and processes start here too: their start-up
        # overlaps the legs before it
        integrity_early = integrity_servers(work, args.seed + 71)
        spreading.append(integrity_early[2])
        holders = Holders(base, work, "piggyback", ec.TOTAL_SHARDS)
        try:
            holders.start()
            drive("net plane repair", net_plane_leg, np, port, holders, work,
                  res, pb, plane_plan)
        finally:
            holders.stop()
        drive("spread piggyback", spread_leg, torch, port, work, base, res,
              pb["shas"], dat, "piggyback", spreading[1])
        integrity = drive("integrity", integrity_leg, np, port, work, base,
                          res, args.seed + 71, integrity_early)
        # step 16: the multi-device tier, on the volume before the decode
        # leg rewrites its .dat; the ranks of (c) start now
        t16 = time.perf_counter()
        print("two ranks on one card: NCCL refuses two ranks on one device "
              "(each rank needs a card of its own), so they join over "
              "gloo, their partials staged through pinned host memory")
        # step 14's masters, A and B, and step 20's stack start with
        # step 16's ranks: one start-up wait for the three groups
        cluster_early = cluster_servers(np, work, args.seed + 67)
        spreading.append(cluster_early["procs"])
        event_plane = EventPlane(work).spawn()
        spreading.append(event_plane)
        s3_stack = S3Stack(work, events=event_plane).spawn()
        spreading.append(s3_stack)
        event_plane.watch(s3_stack.filer)
        mtls_cluster = MtlsCluster(work)
        spreading.append(mtls_cluster)
        mtls_cluster.spawn()
        ranks = Ranks(work)
        try:
            mesh = drive("mesh codec", mesh_codec_leg, np, port, work, base,
                         res, args.seed + 73, per_dispatch=2)
            drive("mesh crossover", mesh_crossover_leg, np, port)
            step = drive("sharded step", sharded_step_leg, np, extra=8)
            check_step_parity(torch, np, ops, step.pop("parity"))
            rank_out, ready_s = ranks.run()
        finally:
            ranks.stop()
        check_ranks(torch, rank_out, ready_s)
        print(f"step 16 (the multi-device tier) in "
              f"{time.perf_counter() - t16:.2f} s")
        drive("decode", decode_leg, np, port, base, res, args.seed,
              kernel=False)
        crc_phase(np, crc)
        data = drive("data plane", data_plane_leg, np, port, work,
                     args.seed + 61)
        native = drive("native plane", native_plane_leg, np, port, work,
                       args.seed)
        cluster = drive("cluster", cluster_leg, np, port, work,
                        args.seed + 67, cluster_early)
        tiering = drive("tiering", tiering_leg, np, port, work,
                        args.seed + 79)
        s3 = drive("s3", s3_leg, np, port, work, args.seed + 83, s3_stack,
                   True, kernel=False)
        events = drive("events", event_leg, np, port, work, args.seed + 97,
                       s3_stack, event_plane, kernel=False)
        mtls = drive("mtls", mtls_leg, np, port, work, args.seed + 89,
                     mtls_cluster, kernel=False)
    finally:
        for group in spreading:
            group.stop_processes()
        shutil.rmtree(work, ignore_errors=True)
    if res["encode_launches"] < 1 or \
            any(r[3] < 1 for r in res["rebuilds"]) or pb["launches"] < 1:
        raise AssertionError("the kernel was not launched on every leg of "
                             "the main path")
    # the integrity leg's launches in B's and C's processes
    by_server = integrity["launches"]
    if legs["integrity"] != sum(by_server["A"].values()) + \
            integrity["naive"]["launches"]:
        raise AssertionError(f"integrity: {legs['integrity']} launches in "
                             f"this process, A and the naive server "
                             f"{by_server['A']}, {integrity['naive']}")
    other = {n: sum(by_server[n].values()) for n in ("B", "C")}
    rank_launches = [out["k1_launches"] for out in rank_out]
    mesh_launches = legs["mesh codec"] + legs["mesh crossover"] + \
        legs["sharded step"] + sum(rank_launches)
    s3_k1 = s3["k1_launches"]
    mtls_k1 = mtls["k1_launches"]
    events_k1 = events["k1_launches"]
    launches = sum(legs.values()) + sum(other.values()) + \
        sum(rank_launches) + s3_k1["step"] + mtls_k1["step"] + events_k1
    print(f"main path (flat, native codec, traced, trace repair, streaming, "
          f"degraded flat, scrub flat, tuner, net trace repair, net full "
          f"rebuild, net "
          f"degraded flat, net scrub flat, spread flat, piggyback, plane "
          f"repair, streaming piggyback, degraded piggyback, scrub "
          f"piggyback, net plane repair, spread piggyback, integrity, "
          f"mesh codec, mesh crossover, sharded step, ranks, decode, data "
          f"plane, native plane, cluster, tiering, s3, events, mtls) in "
          f"{time.perf_counter() - t_path:.2f} s: {launches} kernel launches "
          f"= dispatches, 2 a sharded mesh dispatch ({sum(other.values())} "
          f"of them in the integrity leg's B and C, {json.dumps(other)}, "
          f"{sum(rank_launches)} in step 16's ranks, {rank_launches}, "
          f"{s3_k1['step']} in step 20's stack, {json.dumps(s3_k1)}, "
          f"{events_k1} in step 22's (the same stack), "
          f"{mtls_k1['step']} in step 21's cluster, "
          f"{json.dumps(mtls_k1)}), by "
          f"leg in this process {json.dumps(legs)}; builds {build_s:.2f} s")
    print(f"main path walls by leg: {json.dumps(walls)}")
    integrity_scrub = sum(n for server in by_server.values()
                          for what, n in server.items() if "scrub" in what
                          and what != "scrub_repair")
    integrity_repair = by_server["B"]["scrub_repair"] + \
        by_server["B"]["rebuild"]

    card = card_line()
    entries = [
        _k1_entry("gf_matmul", launches, max_err, timed["flat encode"],
                  timed["flat decode (0, 1, 2, 3)"])
        | {"tiering_launches": tiering["launches"],
           "s3_launches": s3_k1, "events_launches": events_k1,
           "mtls_launches": mtls_k1, "host_codec": host_codec},
        _k1_entry("gf_matmul_piggyback",
                  legs["piggyback"] + legs["streaming piggyback"]
                  + legs["spread piggyback"],
                  max(pb_k1_err, pb_err["gf_matmul"]),
                  timed["piggyback emat"],
                  timed["piggyback decode (0, 7, 11, 12)"]),
        _k1_entry("gf_matmul_repair",
                  legs["trace repair"] + legs["plane repair"]
                  + legs["net trace repair"] + legs["net plane repair"]
                  + integrity_repair + s3_k1["rebuild"]
                  + mtls_k1["rebuild"],
                  repair_err,
                  timed["trace combine"], timed["plane repair"],
                  second_key="plane_repair"),
        _k1_entry("gf_matmul_degraded",
                  legs["degraded flat"] + legs["degraded piggyback"]
                  + legs["net degraded flat"]
                  + data["launches"]["degraded"]
                  + native["launches"]["degraded"]
                  + cluster["launches"]["degraded"]
                  + integrity["naive"]["launches"]
                  + s3_k1["cold"] + s3_k1["warm"] + s3_k1["rebuilt"]
                  + events_k1 + mtls_k1["cold"] + mtls_k1["warm"]
                  + mtls_k1["rebuilt"],
                  max(read_err["degraded flat (1,10)"],
                      read_err["degraded piggyback (32,320)"]),
                  timed["degraded flat wide"], timed["degraded piggyback wide"],
                  second_key="piggyback_wide")
        | {"needle_batch": _timed_keys(timed["degraded flat needle batch"]),
           "native_plane_launches": native["launches"]},
        _k1_entry("gf_matmul_scrub",
                  legs["scrub flat"] + legs["scrub piggyback"]
                  + legs["net scrub flat"] + integrity_scrub,
                  max(read_err["scrub flat (4,14)"],
                      read_err["scrub piggyback (128,448)"]),
                  timed["scrub flat"], timed["scrub piggyback"],
                  second_key="piggyback"),
        _k1_entry("gf_matmul_mesh", mesh_launches, mesh_err,
                  timed["mesh lane encode"], timed["mesh rebuild partial"],
                  second_key="rebuild_partial")
        | {"launches_by_step": {
            "mesh codec": legs["mesh codec"],
            "mesh crossover": legs["mesh crossover"],
            "sharded step": legs["sharded step"],
            "ranks": rank_launches},
           "mesh_encode_mb_s": mesh["encode"]["mb_s"],
           "mesh_rebuild_mb_s": mesh["rebuild"]["mb_s"]}]
    for u, dt in VARIANTS:
        name = rs_bitplane.variant_name(u, dt)
        flat_row = next(row for row in exp_flat if row["name"] == name)
        pb_row = next(row for row in exp_pb if row["name"] == name)
        entries.append({
            "name": name, "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf_bitplane.cu",
            "replaces": "tools/kernel_exp.py:44" if u == 1
            else "tools/kernel_exp.py:97",
            "replaces_function": "tools/kernel_exp.py::make_fn" if u == 1
            else "tools/kernel_exp.py::make_fn_batched",
            "launches": bp_launches[name], "matches_plain": True,
            "max_abs_err": bp_err[name], "library_ms": None}
            | _bp_numbers(flat_row)
            | {"at_piggyback": _bp_numbers(pb_row)})
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _k1_entry(name, launches, max_err, main, second,
              second_key="decode_plan") -> dict:
    """A kernels-line entry of K1 for one class of main-path products:
    the first matrix's numbers (the encode matrix, or the trace combine),
    the plan's pairs per column and table bytes, and the second matrix's
    numbers beside them under ``second_key`` (the decode plan, or the
    plane-repair matrix), all measured in this run."""
    return {
        "name": name, "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:82",
        "replaces_function": "seaweedfs_tpu/ops/rs_pallas.py::_fused_fn",
        "launches": launches, "matches_plain": True,
        "max_abs_err": max_err, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": main["shape"],
        **_plan_keys(main), second_key: _timed_keys(second),
    }


def _plan_keys(t) -> dict:
    return {"pairs_per_column": t["plan"]["pairs_per_column"],
            "table_bytes": t["plan"]["table_bytes"],
            "plan_build_ms": t["plan"]["build_ms"]}


def _timed_keys(t) -> dict:
    """One timed shape's numbers, for beside a kernels-line entry's own."""
    return {key: t[key] for key in ("shape", "ms", "plain_ms",
                                    "bound_ms")} | _plan_keys(t)


def _bound_kind(row, key="bound") -> str:
    """"bytes" or "operations" from a kernel_exp row's "int8 ops" etc."""
    return "bytes" if row[f"{key}_by"] == "bytes" else "operations"


def _bp_numbers(row) -> dict:
    """A bit-plane variant's numbers at one shape, from its kernel_exp
    row. bound_ms is the function's own bound (the bytes, or a
    multiply-add per one of the lift); dense_bound_ms counts the whole
    lift the TPU kernel multiplies and tile_bound_ms the lift tiles this
    kernel keeps, zeros inside them included: both count more work than
    the function needs."""
    return {key: row[key] for key in (
        "shape", "ms", "plain_ms", "bound_ms", "mb_s", "r2",
        "dense_bound_ms", "tile_bound_ms", "lift_ones", "tiles_kept",
        "tiles_dense", "product_alone_ms")} | {
        "bound_by": _bound_kind(row),
        "dense_bound_by": _bound_kind(row, "dense_bound"),
        "tile_bound_by": _bound_kind(row, "tile_bound")}


def kernel_exp_phase(torch, kernel_exp, rs_bitplane, gf256, ops_codec, dev,
                     seed):
    """The port's kernel_exp at RS(10,4) x 8 MiB and at the piggyback
    emat (128,320) x 262,144: K1 and every bit-plane variant, time per
    launch, chained rate, bound, exactness. The bit-plane wrappers'
    launch counts start from 0 here and are read at the end; each
    variant's share comes from kernel_exp's rows."""
    from seaweedfs_tpu_torch.ops.device_stats import DEVICE_STATS, K6A, K6B
    DEVICE_STATS.reset_counts()
    emat = ops_codec.piggyback_plan(10, 4).emat
    flat = kernel_exp.run_table(gf256.build_matrix(10, 14)[10:], MAIN_N, seed,
                                dev, label="kernel_exp ")
    pb = kernel_exp.run_table(emat, PB_N, seed, dev, label="kernel_exp ")
    totals = (DEVICE_STATS.launch_count(K6A),
              DEVICE_STATS.launch_count(K6B))
    if not all(row["exact"] for row in flat + pb):
        raise AssertionError("a kernel_exp kernel is not exact")
    launches = {rs_bitplane.variant_name(u, dt): 0 for u, dt in VARIANTS}
    for row in flat + pb:
        if row["name"] in launches:
            launches[row["name"]] += row["launches"]
    by_wrapper = (sum(n for (u, _), n in zip(VARIANTS, launches.values())
                      if u == 1),
                  sum(n for (u, _), n in zip(VARIANTS, launches.values())
                      if u > 1))
    if by_wrapper != totals:
        raise AssertionError(f"per-variant launches {launches} do not sum "
                             f"to the wrappers' counts {totals}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched in the "
                                 f"kernel_exp phase")
    for at, rows in enumerate((flat, pb)):
        for row in rows:
            if row["name"] not in PREV_BP_MS:
                continue
            prev = PREV_BP_MS[row["name"]][at]
            print(f"kernel_exp {row['name']} {row['shape']}: "
                  f"{row['ms']:.4f} ms, previous kernel {prev} ms "
                  f"({prev / row['ms']:.1f}x faster), "
                  f"{row['ms'] / row['bound_ms']:.2f}x the bound "
                  f"{row['bound_ms']:.4f} ms, "
                  f"{row['ms'] / row['tile_bound_ms']:.2f}x the tile bound "
                  f"{row['tile_bound_ms']:.4f} ms")
    alone = [yardsticks(torch, kernel_exp, rs_bitplane, coeffs, n, dev)
             for coeffs, n in ((gf256.build_matrix(10, 14)[10:], MAIN_N),
                               (emat, PB_N))]
    for row, times in zip((flat, pb), alone):
        for r in row:
            r["product_alone_ms"] = times
    print(f"kernel_exp: bit-plane launches {json.dumps(launches)}")
    return flat, pb, launches


def yardsticks(torch, kernel_exp, rs_bitplane, coeffs, n, dev):
    """The product alone, lift (8r, 8k) x planes, with planes unpacked
    beforehand and stored (n, 8k): torch._int_mm with the planes passed
    transposed (the column-major B cuBLASLt's int8 product takes) and
    torch.matmul in bf16. No unpack, no pack; a yardstick for the
    tensor-core loop, never called by the port. Returns {call: ms}; a call
    that fails fails the smoke."""
    lift = torch.from_numpy(rs_bitplane.fuse_bitmat(coeffs)).to(dev)
    r8, k8 = lift.shape
    planes = torch.randint(0, 2, (n, k8), dtype=torch.int8, device=dev)
    calls = {"torch._int_mm": (lambda a, b: torch._int_mm(a, b.t()), lift,
                               planes),
             "torch.matmul bf16": (lambda a, b: torch.matmul(a, b.t()),
                                   lift.to(torch.bfloat16),
                                   planes.to(torch.bfloat16))}
    times = {name: kernel_exp.per_launch_ms(fn, a, b)
             for name, (fn, a, b) in calls.items()}
    print(f"the product alone ({r8},{k8}) x ({k8},{n}), planes stored "
          f"({n},{k8}), no unpack, no pack (not used by the port): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items()))
    del lift, planes, calls
    torch.cuda.empty_cache()
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        return run(args)
    except Exception:  # noqa: BLE001 - report and fail the smoke
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
