"""QPNet training/adaptation/decoding orchestrator, the port of
`qpnet_tpu/runQP.py` — the reference's src/runQP.py step structure (1: SI
train, 2: SD update, 3: decode, 4: noise restore, 5: validation sweep)
with the same experiment-naming convention
`A<aux>_W<wav>_d<dense>[_net][_U<up>_V<upwav>]` and the same scp
temp-list rewriting, driven by argparse and in-process worker mains.
Same argv as the JAX package's, plus --device (CUDA unless `--device cpu`),
handed to the training, validation and decoding workers; step 5 reads
`validation_result.yml` through `utils/yamlconf.py` (no PyYAML).

  python -m qpnet_tpu_torch.runQP -w vcc18tr.scp -a vcc18tr.scp -I 200000 -1
"""

from __future__ import annotations

import argparse
import os
import sys

from qpnet_tpu_torch.config import AcousticConfig, _NETWORKS
from qpnet_tpu_torch.data.lists import (
    list_initial, path_check, path_initial, remove_temp_file, templist,
)
from qpnet_tpu_torch.utils.yamlconf import read_validation_record

N_JOBS = int(os.environ.get("QPNET_N_JOBS", "25"))
SEED = 1
DECODE_SEED = 100
DECODE_BATCH_SIZE = 20
# SI checkpoints every CHECK_INTERVAL iterations; SD checkpoints, and the
# step-5 sweep over them, every UPDATE_INTERVAL
CHECK_INTERVAL = 10000
UPDATE_INTERVAL = 100


def get_arguments(argv=None):
    p = argparse.ArgumentParser(description="QPNet orchestrator (runQP)")
    p.add_argument("-w", "--wavlist", required=True)
    p.add_argument("-a", "--auxlist", required=True)
    p.add_argument("-x", "--upwavlist", default=None)
    p.add_argument("-u", "--upauxlist", default=None)
    p.add_argument("-y", "--validwavlist", default=None)
    p.add_argument("-v", "--validauxlist", default=None)
    p.add_argument("-e", "--evallist", default=None)
    p.add_argument("-F", "--f0factor", default=None)
    p.add_argument("-f", "--fs", default="22050")
    p.add_argument("-g", "--gpuid", default=None,
                   help="accepted for parity; the device is --device")
    p.add_argument("-n", "--network", default="default")
    p.add_argument("-d", "--dense", type=int, default=8)
    p.add_argument("-I", "--iters", default="200000")
    p.add_argument("-U", "--uiters", default="3000")
    p.add_argument("-R", "--resume", default=None)
    p.add_argument("-M", "--model_iters", default="final")
    p.add_argument("-m", "--multi", action="store_true",
                   help="multi-speaker (skip SD update for decode)")
    p.add_argument("-r", "--replace", action="store_true")
    p.add_argument("-1", "--step1", action="store_true")
    p.add_argument("-2", "--step2", action="store_true")
    p.add_argument("-3", "--step3", action="store_true")
    p.add_argument("-4", "--step4", action="store_true")
    p.add_argument("-5", "--step5", action="store_true")
    p.add_argument("testspk", nargs="?", default=None)
    p.add_argument("--prj_dir", default=os.environ.get("QPNET_PRJ_DIR", "."))
    p.add_argument("--corpus", default="VCC2018")
    p.add_argument("--n_jobs", type=int, default=N_JOBS)
    p.add_argument("--decode_quantize", default="none",
                   choices=("none", "w8a8", "int8_weights"),
                   help="decode numerics: w8a8 = int8 weights and "
                        "activations in the generation kernel (the deep "
                        "Rd10Rr3Ed4Er1 network's serving branch)")
    p.add_argument("--decode_batch_size", type=int, default=None,
                   help="utterances per decode engine call (default: the "
                        "reference's 20); 0 = whole sorted set, sliced "
                        "into throughput-optimal kernel batches")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="training math for steps 1/2: float32 = "
                        "reference-parity; bfloat16 = mixed precision")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the torch device of the workers")
    return p.parse_args(argv)


def main(argv=None):
    args = get_arguments(argv)
    steps = [False, args.step1, args.step2, args.step3, args.step4,
             args.step5]
    if not any(steps):
        raise SystemExit("Please specify steps with options (-1..-5)")

    feat_format = "h5"
    wav_mode = "noiseshaped"
    synonym_wavtype = f"wav_{feat_format}_ns"
    restored_mode = "restored"
    mag, pow_adjust = 0.5, 1.0
    feat_param = AcousticConfig(fs=int(args.fs), shiftms=5)
    network = "qpnet"
    synonym_root = "rootpath"

    dense_factor = args.dense
    aux_version = os.path.basename(args.auxlist).split(".")[0].split("-")[-1]
    wav_version = os.path.basename(args.wavlist).split(".")[0].split("-")[-1]
    model_version = f"A{aux_version}_W{wav_version}_d{dense_factor}"
    net_name = args.network
    if net_name != "default":
        model_version = f"{model_version}_{net_name}"
    net_spec = _NETWORKS[net_name]
    # 0 is meaningful (whole-set decode with engine-side slicing), so an
    # explicit None check — not truthiness — selects the recipe default
    decode_batch_size = (args.decode_batch_size
                         if args.decode_batch_size is not None
                         else (DECODE_BATCH_SIZE if net_name == "default"
                               else net_spec["decode_batch_size"]))
    model_iters = args.model_iters
    dev = ["--device", args.device]

    prj = args.prj_dir.rstrip("/") + "/"
    corpus_dir = f"{prj}corpus/{args.corpus}/"
    scp_dir = f"{corpus_dir}scp/"
    stats = f"{corpus_dir}stats/{wav_version}_stats.{feat_format}"
    expdir = f"{prj}{network}_models/{model_version}/"
    outdir = f"{prj}{network}_output/{model_version}/"
    config = expdir + "model.conf"
    tempdir = f"{prj}temp/"
    path_initial([tempdir])
    path_check([corpus_dir, stats])

    def _get_list(auxlist, wavlist, modelver, setname):
        aux_feats = f"{tempdir}{args.corpus}{modelver}_{setname}auxfeats.tmp"
        templist(auxlist, aux_feats, "",
                 [synonym_root, "wav"], [corpus_dir, feat_format])
        waveforms = f"{tempdir}{args.corpus}{modelver}_{setname}waveforms.tmp"
        templist(wavlist, waveforms, "",
                 [synonym_root, "wav", ".%s" % synonym_wavtype],
                 [corpus_dir, synonym_wavtype, ".wav"])
        return aux_feats, waveforms

    # STEP 1: SI training (temp lists built only when consumed)
    if steps[1]:
        aux_feats, waveforms = _get_list(scp_dir + args.auxlist,
                                         scp_dir + args.wavlist,
                                         model_version, "training")
        # -R <iter> resumes from that checkpoint; -R auto resumes from
        # the newest checkpoint in the expdir (trainer-side autoresume)
        if args.resume == "auto":
            resume = "auto"
        else:
            resume = (expdir + f"checkpoint-{args.resume}.pkl"
                      if args.resume else "None")
            if resume != "None":
                path_check([resume])
        from qpnet_tpu_torch.bin import qpnet_train
        qpnet_train.main([
            "--waveforms", waveforms, "--feats", aux_feats,
            "--stats", stats, "--expdir", expdir, "--config", config,
            "--n_aux", str(feat_param.aux_dim),
            "--dilationF_depth", str(net_spec["dilationF_depth"]),
            "--dilationF_repeat", str(net_spec["dilationF_repeat"]),
            "--dilationA_depth", str(net_spec["dilationA_depth"]),
            "--dilationA_repeat", str(net_spec["dilationA_repeat"]),
            "--kernel_size", str(net_spec["kernel_size"]),
            "--dense_factor", str(dense_factor),
            "--upsampling_factor", str(feat_param.upsampling_factor),
            "--feature_type", feat_param.feature_type,
            "--feature_format", feat_format,
            "--batch_length", str(net_spec["batch_length"]),
            "--batch_size", str(net_spec["batch_size"]),
            "--max_length", str(net_spec["max_length"]),
            "--f0_threshold", str(net_spec["f0_threshold"]),
            "--iters", args.iters,
            "--checkpoint_interval", str(CHECK_INTERVAL),
            "--dtype", args.dtype,
            "--seed", str(SEED), "--resume", resume, "--verbose", "1"]
            + dev)
        remove_temp_file([waveforms, aux_feats])

    validation_interval = range(CHECK_INTERVAL, int(args.iters) + 1,
                                CHECK_INTERVAL)

    # STEP 2 path setup: SD adaptation
    if (not args.multi) and (steps[2] or steps[3] or steps[4] or steps[5]):
        if args.upauxlist is None or args.upwavlist is None:
            if steps[2]:
                print("Please assign -u UPAUXLIST and -x UPWAVLIST, "
                      "or use --multi.")
                sys.exit(0)
        else:
            pretrain = f"{expdir}/checkpoint-final.pkl"
            upaux_version = os.path.basename(
                args.upauxlist).split(".")[0].split("-")[-1]
            upwav_version = os.path.basename(
                args.upwavlist).split(".")[0].split("-")[-1]
            model_version = f"{model_version}_U{upaux_version}_V{upwav_version}"
            upaux_feats, upwaveforms = _get_list(
                scp_dir + args.upauxlist, scp_dir + args.upwavlist,
                model_version, "updating")
            si_config = config
            expdir = f"{prj}{network}_models/{model_version}/"
            outdir = f"{prj}{network}_output/{model_version}/"
            validation_interval = range(UPDATE_INTERVAL,
                                        int(args.uiters) + 1,
                                        UPDATE_INTERVAL)
            if steps[2]:
                path_check([pretrain])
                if args.resume == "auto":
                    resume = "auto"
                else:
                    resume = (expdir + f"checkpoint-{args.resume}.pkl"
                              if args.resume else "None")
                from qpnet_tpu_torch.bin import qpnet_update
                qpnet_update.main([
                    "--waveforms", upwaveforms, "--feats", upaux_feats,
                    "--stats", stats, "--expdir", expdir,
                    "--config", si_config, "--pretrain", pretrain,
                    "--batch_length", str(net_spec["batch_length"]),
                    "--batch_size", str(net_spec["batch_size"]),
                    "--max_length", str(net_spec["max_length"]),
                    "--f0_threshold", str(net_spec["f0_threshold"]),
                    "--iters", args.uiters,
                    "--checkpoint_interval", str(UPDATE_INTERVAL),
                    "--dtype", args.dtype,
                    "--resume", resume, "--seed", str(SEED),
                    "--verbose", "1"] + dev)
                # SD expdir reuses the SI model.conf contents
                import shutil
                os.makedirs(expdir, exist_ok=True)
                shutil.copy(si_config, expdir + "model.conf")
            config = expdir + "model.conf"
            remove_temp_file([upwaveforms, upaux_feats])

    # STEPS 3-4: decoding + noise restore
    if args.evallist is not None and (steps[3] or steps[4]):
        if args.testspk is None:
            print("Please assign the evaluation speaker.")
            sys.exit(0)
        testspk = args.testspk
        outdir_eval = os.path.join(outdir, wav_mode, testspk, model_iters)
        test_feats = f"{tempdir}{args.corpus}{model_version}_testfeats.tmp"
        tlist = scp_dir + args.evallist
        keyword = [synonym_root, "wav"]
        subword = [corpus_dir, feat_format]
        if args.f0factor is None:
            f0_factor = 1.0
            outdir_eval = os.path.join(outdir_eval, "feat_id.wav")
        else:
            f0_factor = float(args.f0factor)
            outdir_eval = os.path.join(outdir_eval,
                                       f"feat_id_{args.f0factor}.wav")
        if steps[3]:
            final_checkpoint = f"{expdir}/checkpoint-{model_iters}.pkl"
            path_check([final_checkpoint, config])
            if not list_initial(args.replace, feat_format, tlist, test_feats,
                                outdir_eval, keyword, subword):
                print(f"{args.evallist} is skipped")
            else:
                from qpnet_tpu_torch.bin import qpnet_decode
                qpnet_decode.main([
                    "--feats", test_feats, "--stats", stats,
                    "--config", config, "--outdir", outdir_eval,
                    "--checkpoint", final_checkpoint,
                    "--fs", str(feat_param.fs),
                    "--batch_size", str(decode_batch_size),
                    "--seed", str(DECODE_SEED),
                    "--f0_factor", str(f0_factor),
                    "--f0_dim_index", str(feat_param.f0_dim_idx),
                    "--quantize", args.decode_quantize] + dev)
        if steps[4]:
            path_check([os.path.dirname(outdir_eval)])
            writedir = outdir_eval.replace(wav_mode, restored_mode)
            templist(tlist, test_feats, "", keyword, subword)
            from qpnet_tpu_torch.bin import noise_restored
            noise_restored.main([
                "--feats", test_feats, "--stats", stats,
                "--outdir", outdir_eval, "--writedir", writedir,
                "--feature_type", feat_param.feature_type,
                "--feature_format", feat_format,
                "--pow_adjust", str(pow_adjust),
                "--fs", str(feat_param.fs),
                "--shiftms", str(feat_param.shiftms),
                "--fftl", str(feat_param.fftl),
                "--mcep_dim_start", str(feat_param.mcep_dim_start),
                "--mcep_dim_end", str(feat_param.mcep_dim_end),
                "--mcep_alpha", str(feat_param.mcep_alpha),
                "--mag", str(mag), "--n_jobs", str(args.n_jobs),
                "--inv", "false"])
        remove_temp_file([test_feats])

    # STEP 5: validation sweep
    if steps[5]:
        if args.validauxlist is None or args.validwavlist is None:
            print("Please assign -v VALIDAUXLIST and -y VALIDWAVLIST")
            sys.exit(0)
        validaux_feats, validwaveforms = _get_list(
            scp_dir + args.validauxlist, scp_dir + args.validwavlist,
            model_version, "validation")
        from qpnet_tpu_torch.bin import qpnet_validate
        for it in validation_interval:
            checkpoint = f"{expdir}/checkpoint-{it}.pkl"
            path_check([checkpoint])
            qpnet_validate.main([
                "--waveforms", validwaveforms, "--feats", validaux_feats,
                "--stats", stats, "--resultdir", expdir,
                "--config", config, "--checkpoint", checkpoint,
                "--batch_length", str(net_spec["batch_length"]),
                "--batch_size", str(net_spec["batch_size"]),
                "--max_length", str(net_spec["max_length"]),
                "--verbose", "1"] + dev)
        remove_temp_file([validwaveforms, validaux_feats])
        # the reference leaves picking the best iteration to a human
        # reading the yml (run_QP.sh:62-71 comment); also print it
        results = read_validation_record(
            os.path.join(expdir, "validation_result.yml"))
        if results:
            best = min(results, key=results.get)
            best_it = best.split("-")[-1].split(".")[0]
            print(f"best iteration: {best_it} "
                  f"(loss {results[best]:.4f}) -> decode with -M {best_it}")


if __name__ == "__main__":
    main()
